// Native layout-planner core for brickjax.
//
// The reference's layout machinery is C++ templates evaluated inline in
// the hot setup path (include/brick.h, include/bricksetup.h:30-90,
// include/brick-mpi.h:266-296).  The JAX rebuild plans on the host; this
// library provides the O(nbricks * 3^dims) pieces natively for large
// grids, bound via ctypes (brickjax/core/native.py) with a numpy
// fallback.  Semantics are golden-tested against the Python planner.
//
// Build: make -C csrc   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Full 3^dims adjacency from a brick-grid table.
// grid: int32[gshape[0] * ... * gshape[dims-1]] row-major, values =
// storage brick indices.  Cells outside the table resolve to brick 0.
// adj: int32[nbricks, 3^dims], written in place (caller zero-fills).
// Mirrors include/bricksetup.h:30-70 / brick-mpi.h:266-296: column c
// encodes base-3 offset digits, most-significant digit = outermost dim.
void adjacency_from_grid(const int32_t* grid, const int64_t* gshape,
                         int32_t dims, int64_t nbricks, int32_t* adj) {
  int64_t ncells = 1;
  std::vector<int64_t> stride(dims);
  for (int d = dims - 1; d >= 0; --d) {
    stride[d] = ncells;
    ncells *= gshape[d];
  }
  int64_t ncols = 1;
  for (int d = 0; d < dims; ++d) ncols *= 3;

  std::vector<int64_t> coord(dims);
  std::vector<int64_t> off(dims);
  for (int64_t cell = 0; cell < ncells; ++cell) {
    int64_t rem = cell;
    for (int d = 0; d < dims; ++d) {
      coord[d] = rem / stride[d];
      rem %= stride[d];
    }
    int32_t b = grid[cell];
    if (b < 0 || b >= nbricks) continue;
    int32_t* row = adj + (int64_t)b * ncols;
    for (int64_t c = 0; c < ncols; ++c) {
      int64_t cc = c;
      bool ok = true;
      int64_t ncell = 0;
      for (int d = dims - 1; d >= 0; --d) {
        int64_t digit = cc % 3 - 1;
        cc /= 3;
        int64_t x = coord[d] + digit;
        if (x < 0 || x >= gshape[d]) { ok = false; break; }
        ncell += x * stride[d];
      }
      row[c] = ok ? grid[ncell] : 0;
    }
  }
}

// Involution check: adj[adj[b][c]][ncols-1-c] == b for the given bricks.
// Returns the number of violations.
int64_t check_involution(const int32_t* adj, int64_t ncols,
                         const int32_t* bricks, int64_t n) {
  int64_t bad = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = bricks[i];
    for (int64_t c = 0; c < ncols; ++c) {
      int32_t nb = adj[(int64_t)b * ncols + c];
      if (adj[(int64_t)nb * ncols + (ncols - 1 - c)] != b) ++bad;
    }
  }
  return bad;
}

// n-D Morton ids for every cell of a row-major grid (outermost first).
// Coordinate of the LAST axis is Morton dimension 0
// (ref: include/zmort.h:18-105).
void zmort_ids(const int64_t* shape, int32_t dims, int64_t* out) {
  int64_t ncells = 1;
  std::vector<int64_t> stride(dims);
  for (int d = dims - 1; d >= 0; --d) {
    stride[d] = ncells;
    ncells *= shape[d];
  }
  int maxbits = 0;
  for (int d = 0; d < dims; ++d) {
    int b = 0;
    while ((int64_t(1) << b) < shape[d]) ++b;
    if (b > maxbits) maxbits = b;
  }
  for (int64_t cell = 0; cell < ncells; ++cell) {
    int64_t rem = cell, id = 0;
    for (int d = 0; d < dims; ++d) {
      int64_t coord = rem / stride[d];
      rem %= stride[d];
      int morton_dim = dims - 1 - d;
      for (int bit = 0; bit < maxbits; ++bit)
        id |= ((coord >> bit) & 1) << (bit * dims + morton_dim);
    }
    out[cell] = id;
  }
}

// Data import/export between dense arrays and brick storage — the
// reference's OMP-parallel copyToBrick/copyFromBrick
// (include/bricksetup.h:103-221).  arr is the dense row-major array of
// shape (gshape[d] * bdims[d]); grid maps cells to storage chunks;
// dat is float32[nchunks, step], block written at [grid[cell],
// offset : offset + prod(bdims)].  Inner brick dim is contiguous in
// both layouts, so rows move as memcpy.
void copy_to_bricks_f32(const float* arr, const int32_t* grid,
                        const int64_t* gshape, const int64_t* bdims,
                        int32_t dims, float* dat, int64_t step,
                        int64_t offset, int64_t nchunks) {
  int64_t ncells = 1, belems = 1;
  for (int d = 0; d < dims; ++d) { ncells *= gshape[d]; belems *= bdims[d]; }
  std::vector<int64_t> dstr(dims);
  int64_t acc = 1;
  for (int d = dims - 1; d >= 0; --d) {
    dstr[d] = acc;
    acc *= gshape[d] * bdims[d];
  }
  const int64_t inner = bdims[dims - 1];
  const int64_t nrows = belems / inner;
#pragma omp parallel for schedule(static)
  for (int64_t cell = 0; cell < ncells; ++cell) {
    int32_t b = grid[cell];
    if (b < 0 || b >= nchunks) continue;
    int64_t rem = cell, gc[8];
    for (int d = dims - 1; d >= 0; --d) { gc[d] = rem % gshape[d]; rem /= gshape[d]; }
    float* dst = dat + (int64_t)b * step + offset;
    const int64_t ibase = gc[dims - 1] * bdims[dims - 1];
    for (int64_t r = 0; r < nrows; ++r) {
      int64_t rr = r, src = ibase;
      for (int d = dims - 2; d >= 0; --d) {
        int64_t bc = rr % bdims[d];
        rr /= bdims[d];
        src += (gc[d] * bdims[d] + bc) * dstr[d];
      }
      std::memcpy(dst + r * inner, arr + src, inner * sizeof(float));
    }
  }
}

// Inverse gather: dense array from brick storage over the grid table.
void copy_from_bricks_f32(float* arr, const int32_t* grid,
                          const int64_t* gshape, const int64_t* bdims,
                          int32_t dims, const float* dat, int64_t step,
                          int64_t offset, int64_t nchunks) {
  int64_t ncells = 1, belems = 1;
  for (int d = 0; d < dims; ++d) { ncells *= gshape[d]; belems *= bdims[d]; }
  std::vector<int64_t> dstr(dims);
  int64_t acc = 1;
  for (int d = dims - 1; d >= 0; --d) {
    dstr[d] = acc;
    acc *= gshape[d] * bdims[d];
  }
  const int64_t inner = bdims[dims - 1];
  const int64_t nrows = belems / inner;
#pragma omp parallel for schedule(static)
  for (int64_t cell = 0; cell < ncells; ++cell) {
    int32_t b = grid[cell];
    if (b < 0 || b >= nchunks) continue;
    int64_t rem = cell, gc[8];
    for (int d = dims - 1; d >= 0; --d) { gc[d] = rem % gshape[d]; rem /= gshape[d]; }
    const float* src = dat + (int64_t)b * step + offset;
    const int64_t ibase = gc[dims - 1] * bdims[dims - 1];
    for (int64_t r = 0; r < nrows; ++r) {
      int64_t rr = r, doff = ibase;
      for (int d = dims - 2; d >= 0; --d) {
        int64_t bc = rr % bdims[d];
        rr /= bdims[d];
        doff += (gc[d] * bdims[d] + bc) * dstr[d];
      }
      std::memcpy(arr + doff, src + r * inner, inner * sizeof(float));
    }
  }
}

}  // extern "C"
