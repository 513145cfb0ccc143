// K3: the backward of the port's tie-exact bounds (ops/color_planes.py
// `clip` and `floor_at`, the forms of jnp.clip and jnp.maximum) as one
// elementwise pass: g where lo < x < hi, g / 2 at x == lo or x == hi, 0
// outside; a NaN x passes g, as the two-pass minimum(maximum(x, lo), hi)
// does. `floor_at` passes hi = NaN, which no comparison meets.
//
// This is an elementwise functor for torch.cuda.jiterator, which compiles
// it with NVRTC at first launch and runs it over any strides, broadcasts and
// floating dtypes (T: float, double, c10::BFloat16, c10::Half). The bounds
// arrive as 0-d tensors of x's dtype, so they round as the plain version's.
template <typename T>
T tie_clip_grad(T g, T x, T lo, T hi) {
  return (x < lo || x > hi) ? T(0) : ((x == lo || x == hi) ? g / T(2) : g);
}
