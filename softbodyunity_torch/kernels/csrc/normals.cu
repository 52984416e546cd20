// Area-weighted unit vertex normals for rendering, for Hopper (sm_90a).
// Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/normals.py; its plain PyTorch version is
// softbodyunity_torch/solver/normals.py::vertex_normals.
//
// Replaces no TPU kernel: the JAX package leaves the normals to XLA
// (softbodyunity_tpu/solver/normals.py, a segment sum).  On the card the
// plain version is ~24 PyTorch ops a frame (three gathers, two
// subtractions, a cross product, a cat, D gathers and adds, a norm, a clamp
// and a divide); the host's time to launch them, not their device time,
// held up every rendered frame.  Here the normals are one launch from one
// C call.
//
// Design.  One thread per vertex walks its row of the incident-face table
// in slot order and stops at the first pad (pads end each row, so a pole of
// high valence costs only its own thread).  The table is [depth, n]: slot k
// of 32 consecutive vertices is one coalesced load.  For each face the
// thread computes the face normal from x as the plain version does, p1 - p0
// and p2 - p0, then their cross product in torch.linalg.cross's component
// order, and adds it into a running sum that starts at +0, in the table's
// order.  Each face is computed by each of its three corners (~6 cross
// products a vertex on a cloth grid or a lattice surface) in place of a
// second launch and an [F + 1, 3] plane of face normals; every corner gets
// the same bits.  Then the sum is divided by max(|sum|, 1e-12), so a vertex
// whose faces sum to zero gets a zero normal, as in the plain version.
//
// What bounds it.  Per vertex it must read x (12 B) and its table row (4 D
// B) and write the normal (12 B); the triangles (12 B a face, F ~ 2 n) and
// the corners' x are read again per face, from L2 (x is 786 KB at 64k
// vertices).  ~4-5 MB a call at 64k vertices, ~1.5 us at 3.35 TB/s.  What
// it saves is the host's launching of the plain version's ops, not bytes.
//
// Rounding.  Every operation is an explicit round-to-nearest intrinsic, so
// nvcc contracts nothing into an FMA: the same bits on every run.  The
// plain version's CUDA ops may contract (its cross product), so kernel and
// plain version agree to rounding, not to the bit.  The kernel is a
// template on the scalar: float32 (the benchmark's and every preset's
// dtype) and float64 run the same operations, each in its own precision.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

// The round-to-nearest operations of each scalar type, and the plain
// version's clamp (clamp_min(1e-12) in the tensor's dtype).
template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
  static constexpr float kMinNorm = 1e-12f;
};

template <>
struct Rn<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
  static constexpr double kMinNorm = 1e-12;
};

// tris is [n_face, 3], table [depth, n] with pad n_face, x and out [n, 3].
template <typename T>
__global__ void __launch_bounds__(kThreads) vertex_normals_kernel(
    const T* __restrict__ x, const int* __restrict__ tris,
    const int* __restrict__ table, T* __restrict__ out, int n, int n_face,
    int depth) {
  using R = Rn<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T sx = T(0), sy = T(0), sz = T(0);
  for (int k = 0; k < depth; ++k) {
    const int f = __ldg(table + static_cast<size_t>(k) * n + i);
    if (f >= n_face) break;
    const size_t t = 3 * static_cast<size_t>(f);
    const T* p0 = x + 3 * static_cast<size_t>(__ldg(tris + t));
    const T* p1 = x + 3 * static_cast<size_t>(__ldg(tris + t + 1));
    const T* p2 = x + 3 * static_cast<size_t>(__ldg(tris + t + 2));
    const T x0 = __ldg(p0), y0 = __ldg(p0 + 1), z0 = __ldg(p0 + 2);
    const T ax = R::sub(__ldg(p1), x0);
    const T ay = R::sub(__ldg(p1 + 1), y0);
    const T az = R::sub(__ldg(p1 + 2), z0);
    const T bx = R::sub(__ldg(p2), x0);
    const T by = R::sub(__ldg(p2 + 1), y0);
    const T bz = R::sub(__ldg(p2 + 2), z0);
    sx = R::add(sx, R::sub(R::mul(ay, bz), R::mul(az, by)));
    sy = R::add(sy, R::sub(R::mul(az, bx), R::mul(ax, bz)));
    sz = R::add(sz, R::sub(R::mul(ax, by), R::mul(ay, bx)));
  }
  const T sq = R::add(R::add(R::mul(sx, sx), R::mul(sy, sy)), R::mul(sz, sz));
  T norm = R::sqrt(sq);
  // clamp_min's order: a NaN norm stays NaN
  norm = norm < R::kMinNorm ? R::kMinNorm : norm;
  T* o = out + 3 * static_cast<size_t>(i);
  o[0] = R::div(sx, norm);
  o[1] = R::div(sy, norm);
  o[2] = R::div(sz, norm);
}

}  // namespace

// The scene's tables, packed once by the wrapper; kernels/normals.py
// mirrors it field by field (normals_scene_size checks the two agree).
struct NormalsScene {
  const int* tris;    // [n_face, 3]
  const int* table;   // [depth, n], pad n_face
  int n, n_face, depth;
  int device;         // the CUDA device the tables and x are on
};

extern "C" int normals_scene_size() {
  return static_cast<int>(sizeof(NormalsScene));
}

namespace {

// Launch the normals of x into out on stream, a stream of s->device: one
// launch, n > 0, made with s->device current and the caller's current
// device restored.  Returns the first cudaError_t that is not cudaSuccess.
// Allocates nothing and does not synchronise.
template <typename T>
int launch(const NormalsScene* s, const T* x, T* out, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != s->device)
    err = cudaSetDevice(s->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (s->n + kThreads - 1) / kThreads;
  vertex_normals_kernel<T><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, s->tris, s->table, out, s->n, s->n_face, s->depth);
  err = cudaGetLastError();
  if (current != s->device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

// The normals of float32 x, and of float64 x: see launch() above.
extern "C" int vertex_normals_f32(const NormalsScene* s, const float* x,
                                  float* out, void* stream) {
  return launch(s, x, out, stream);
}

extern "C" int vertex_normals_f64(const NormalsScene* s, const double* x,
                                  double* out, void* stream) {
  return launch(s, x, out, stream);
}

extern "C" const char* normals_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
