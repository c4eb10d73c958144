"""Driver smoke + numerics on the 8-device CPU mesh (the reference CI's
build-and-run analog) — weak with/without overlap, 4-D 9pt weak run,
and the graft entry points."""



def test_weak_driver_3d_and_overlap(capsys):
    from brickjax.drivers import weak

    r1 = weak.run(dims=(16, 16, 16), bdim=(4, 4, 8), stencil="mpi7pt",
                  st_iter=2, mesh_shape=(2, 2, 2), iters=3)
    r2 = weak.run(dims=(16, 16, 16), bdim=(4, 4, 8), stencil="mpi7pt",
                  st_iter=2, mesh_shape=(2, 2, 2), iters=3, overlap=True)
    out = capsys.readouterr().out
    assert out.count("validated against array twin: OK") == 2
    assert "GStencil/s" in out
    assert r1["step"] > 0 and r2["step"] > 0


def test_weak_driver_4d():
    from brickjax.drivers import weak

    weak.run(dims=(4, 4, 8, 16), bdim=(2, 2, 4, 8),
             stencil="mpi9pt", st_iter=1, mesh_shape=(2, 1, 2, 2),
             iters=2)


def test_weak_driver_13pt_deep_ghost():
    """radius-2 stencil, 2 iterations on one exchange (ST_ITER ghost
    trade, ref: weak/main.cpp:203-212)."""
    from brickjax.drivers import weak

    weak.run(dims=(16, 16, 16), bdim=(4, 4, 8), stencil="mpi13pt",
             st_iter=2, mesh_shape=(2, 2, 2), iters=2)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_graft_entry_single(monkeypatch, tmp_path):
    import jax

    import __graft_entry__ as ge

    # entry() turns the compile cache on; keep it out of the checkout
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
