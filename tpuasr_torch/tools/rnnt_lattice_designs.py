"""Time the RNN-T lattice's warp route (kernels #8 / #9,
``csrc/rnnt_lattice.cu``) against the simpler designs it was chosen over.

Each alternative is built from the kernel source by textual edits (each
edit's target must occur exactly once), into ``build/rnnt_lattice_designs/``;
the source itself is not touched. The designs:

- ``base``: the source as it is: input rings filled by rows of the device
  arrays (coalesced), a share of K or K + 1 rows a step beside the chain;
  a step stores its own cells to device memory, U floats apart;
- ``bunched``: the same fills, each chunk's at once where the chunk starts
  (no share a step, so no K + 1 instance would be needed);
- ``output_ring``: a step writes its cells into a shared-memory output ring
  of two chunks, which the warp copies out by rows (coalesced), a share a
  step (the ring budget of 10 / 16 chunks in place of 8 / 12);
- ``no_input_ring``: no input ring: a step loads the next step's terms from
  device memory (the next diagonal's cells, U floats apart);
- ``branchy``: the ring copies and the stores under a branch each in place
  of the predicated PTX instructions.

Every design is held against the plain versions (`rnnt_alpha_plain`,
`rnnt_beta_grad_plain`) with chip_smoke.py phase 3's tolerances, then all
are timed in turns (base first, each design, then back in reverse order),
by CUDA events behind a sleep kernel (chip_smoke.py's `_time_ms`), at the
training step's shapes (B 12: T' 191, U+1 33; T' 63 and 127, U+1 17) and at
U+1 32 (a share of K + 1) and 128 (K 4). Needs the card and nvcc; run from
the root of the checkout:

    python -m tpuasr_torch.tools.rnnt_lattice_designs

It prints a line a shape and kernel, and a JSON object of every reading last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np

from tpuasr_torch.ops import _build

ALPHA, BETA = "rnnt_alpha_warp_kernel", "rnnt_beta_grad_warp_kernel"

# (kernel whose body holds the target or None for the whole source, old, new)
BUNCHED = [
    (ALPHA, """  f.start(bl, lb, 2 * C, lc, P, U1, lane);
#pragma unroll
  for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);  // the share of diagonal 0
""", """  f.start(bl, lb, 2 * C, lc, P, U1, lane);
"""),
    (ALPHA, """    if (ci > 0) f.start(bl, lb, (ci + 2) * C, lc, P, U1, lane);
""", """    if (ci > 0) f.start(bl, lb, (ci + 2) * C, lc, P, U1, lane);
    for (int i = 0; i < (C + U1 + R - 1) / R; ++i) f.copy(rb, rl, R, T, U1);
"""),
    (ALPHA, """#pragma unroll
      for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);
""", ""),
    (BETA, """    if (ci > 0) f.start(bl, al, lb, n_lo(ci + 2), lc, P, U1, lane);
""", """    if (ci > 0) f.start(bl, al, lb, n_lo(ci + 2), lc, P, U1, lane);
    for (int i = 0; i < rows; ++i) f.copy(rb, ra, rl, R, T, U1);
"""),
    (BETA, """#pragma unroll
      for (int q = 0; q < Q; ++q) f.copy(rb, ra, rl, R, T, U1);
""", ""),
]

# the output ring: a step writes its cells into shared memory (2C slots of
# 32K floats, one vector a lane), and each step of chunk i copies a share of
# chunk i - 1's real cells out by rows of the device arrays (coalesced), the
# last chunks after the sweep
FLUSH = """// K consecutive floats of registers to shared memory (at a multiple of K
// floats), as the widest vectors K allows
template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      reinterpret_cast<float4*>(p)[k / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) reinterpret_cast<float2*>(p)[k / 2] = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = v[k];
  }
}

// the real cells of a chunk from the output ring `ro` into `out` [T, U1],
// and with TWO from `ro2` into `out2` [T, U]; rows n_lo - U .. n_lo + C - 1
struct Flush {
  float *o, *o2;
  int s, r, c;
  __device__ __forceinline__ void start(float* out, float* out2, int n_lo, int lc, int P,
                                        int U1, int lane) {
    const int n = n_lo + (lane & ((1 << lc) - 1));
    s = (n & ((2 << lc) - 1)) * P;
    r = n_lo - (U1 - 1) + (lane >> lc);
    c = n - r;
    o = out + (r * U1 + c);
    o2 = out2 == nullptr ? nullptr : out2 + (r * (U1 - 1) + c);
  }
  template <int Q, bool TWO>
  __device__ __forceinline__ void copy(const float* ro, const float* ro2, int R, int T,
                                       int U1) {
    const int U = U1 - 1;
    float v[Q], v2[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int d = s + min(max(c - j * R, 0), U);
      v[j] = ro[d];
      if constexpr (TWO) v2[j] = ro2[d];
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int rj = r + j * R, cj = c - j * R;
      const bool real = (unsigned)rj < (unsigned)T && (unsigned)cj < (unsigned)U1;
      st_global_if(o + j * R * U, v[j], real);
      if constexpr (TWO) st_global_if(o2 + j * R * (U - 1), v2[j], real && cj < U);
    }
    r += Q * R;
    c -= Q * R;
    o += Q * R * U;
    if constexpr (TWO) o2 += Q * R * (U - 1);
  }
};

constexpr int kFlushRows = 8;

"""
OUTPUT_RING = [
    (None, "template <int K, int Q>\n__global__ void __launch_bounds__(kWarp)\n"
           "rnnt_alpha_warp_kernel(", FLUSH + "template <int K, int Q>\n__global__ void "
           "__launch_bounds__(kWarp)\nrnnt_alpha_warp_kernel("),
    (ALPHA, "  const uint32_t rb = smem_addr(ring), rl = rb + 4 * W;  // blank, label\n",
     "  const uint32_t rb = smem_addr(ring), rl = rb + 4 * W;\n  float* ro = ring + 2 * W;\n"),
    (ALPHA, "  const int nc = (N + C - 1) >> lc;\n",
     "  const int nc = (N + C - 1) >> lc;\n  const int flush_rows = (C + U + R - 1) / R;\n"),
    (ALPHA, "  if (lane == 0) al[0] = 0.f;  // alpha[0, 0], diagonal 0\n",
     "  if (lane == 0) ro[0] = 0.f;\n  Flush g;\n  g.start(al, nullptr, -C, lc, P, U1, lane);\n"),
    (ALPHA, "    if (ci > 0) f.start(bl, lb, (ci + 2) * C, lc, P, U1, lane);\n",
     """    if (ci > 0) {
      f.start(bl, lb, (ci + 2) * C, lc, P, U1, lane);
      g.start(al, nullptr, (ci - 1) * C, lc, P, U1, lane);
    }
"""),
    (ALPHA, "      for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);\n",
     "      for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);\n"
     "      g.copy<Q, false>(ro, nullptr, R, T, U1);\n"),
    (ALPHA, """#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int u = lane * K + k;
        st_global_if(al + ((n - u) * U1 + u), a[k], (unsigned)(n - u) < (unsigned)T && u < U1);
      }
""", "      store_k<K>(ro + (n & (2 * C - 1)) * P + lane * K, a);\n"),
    (ALPHA, "  asm volatile(\"\" ::: \"memory\");", """  __syncwarp();
  for (int i = Q * (N - (nc - 1) * C); i < flush_rows; i += kFlushRows)
    g.copy<kFlushRows, false>(ro, nullptr, R, T, U1);
  g.start(al, nullptr, (nc - 1) * C, lc, P, U1, lane);
  for (int i = 0; i < flush_rows; i += kFlushRows) g.copy<kFlushRows, false>(ro, nullptr, R, T, U1);
  asm volatile("" ::: "memory");"""),
    (BETA, "  const uint32_t rb = smem_addr(ring), rl = rb + 4 * W, ra = rb + 8 * W;"
           "  // blank, label, alpha\n",
     "  const uint32_t rb = smem_addr(ring), rl = rb + 4 * W, ra = rb + 8 * W;\n"
     "  float* rgb = ring + 3 * W;\n  float* rgl = rgb + W / 2;\n"),
    (BETA, "  f.start(bl, al, lb, n_lo(2), lc, P, U1, lane);\n",
     "  Flush h;\n  h.start(gb, gl, n_lo(-1), lc, P, U1, lane);\n"
     "  f.start(bl, al, lb, n_lo(2), lc, P, U1, lane);\n"),
    (BETA, "    if (ci > 0) f.start(bl, al, lb, n_lo(ci + 2), lc, P, U1, lane);\n",
     """    if (ci > 0) {
      f.start(bl, al, lb, n_lo(ci + 2), lc, P, U1, lane);
      h.start(gb, gl, n_lo(ci - 1), lc, P, U1, lane);
    }
"""),
    (BETA, "      for (int q = 0; q < Q; ++q) f.copy(rb, ra, rl, R, T, U1);\n",
     "      for (int q = 0; q < Q; ++q) f.copy(rb, ra, rl, R, T, U1);\n"
     "      h.copy<Q, true>(rgb, rgl, R, T, U1);\n"),
    (BETA, """#pragma unroll
      for (int k = 0; k < K; ++k) {  // the step's cells, U floats apart
        const int u = lane * K + k;
        const bool real = (unsigned)(n - u) < (unsigned)T && u < U1;
        st_global_if(gb + ((n - u) * U1 + u), ob[k], real);
        st_global_if(gl + ((n - u) * U + u), ol[k], real && u < U);
      }
""", """      const int o = (n & (2 * C - 1)) * P + lane * K;
      store_k<K>(rgb + o, ob);
      store_k<K>(rgl + o, ol);
"""),
    (BETA, "    cp_async_commit();\n  }\n}", """    cp_async_commit();
  }
  __syncwarp();
  for (int i = Q * (top - (nc - 1) * C + 1); i < rows; i += kFlushRows)
    h.copy<kFlushRows, true>(rgb, rgl, R, T, U1);
  h.start(gb, gl, n_lo(nc - 1), lc, P, U1, lane);
  for (int i = 0; i < rows; i += kFlushRows) h.copy<kFlushRows, true>(rgb, rgl, R, T, U1);
}"""),
    (None, "ring_log2(U1, k, ch, q, U1, 8, &smem)", "ring_log2(U1, k, ch, q, U1, 10, &smem)"),
    (None, "ring_log2(U1, k, ch, q, U1 - 1, 12, &smem)",
     "ring_log2(U1, k, ch, q, U1 - 1, 16, &smem)"),
]

NO_INPUT_RING = [
    (ALPHA, "  const int ul = ulens[b];\n", """  const int ul = ulens[b];
  // step m's terms at the lane's columns, from device memory
  auto terms = [&](int m, float (&xb)[K], float (&xl)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = lane * K + k, t = m - u;
      xb[k] = t >= 1 && t <= T && u < U1 ? bl[(t - 1) * U1 + u] : kNeg;
      xl[k] = t >= 0 && t < T && u >= 1 && u < U1 ? lb[t * U + u - 1] : kNeg;
    }
  };
"""),
    (ALPHA, """    float eb[K], el[K];  // this step's blank and label terms
    load_k<K>(ring + (n & (4 * C - 1)) * P + lane * K, eb);
    load_k<K>(ring + W + (n & (4 * C - 1)) * P + lane * K, el);
""", """    float eb[K], el[K];
    terms(n, eb, el);
"""),
    (ALPHA, """      float fb[K], fl[K];
      const float* s = ring + ((n + 1) & (4 * C - 1)) * P + lane * K;
      load_k<K>(s, fb);
      load_k<K>(s + W, fl);
#pragma unroll
      for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);
""", """      float fb[K], fl[K];
      terms(n + 1, fb, fl);
"""),
    (BETA, "  const int ul = ulens[b];\n", """  const int ul = ulens[b];
  auto terms = [&](int m, float (&xb)[K], float (&xl)[K], float (&xa)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = lane * K + k, t = m - u;
      const bool real = t >= 0 && t < T && u < U1;
      xb[k] = real ? bl[t * U1 + u] : 0.f;
      xl[k] = real && u < U ? lb[t * U + u] : kNeg;
      xa[k] = real ? al[t * U1 + u] : kNeg;
    }
  };
"""),
    (BETA, """    float eb[K], el[K], ea[K];
    {
      const float* s = ring + (n & (4 * C - 1)) * P + lane * K;
      load_k<K>(s, eb);
      load_k<K>(s + W, el);
      load_k<K>(s + 2 * W, ea);
    }
""", """    float eb[K], el[K], ea[K];
    terms(n, eb, el, ea);
"""),
    (BETA, """      const float* s = ring + ((n - 1) & (4 * C - 1)) * P + lane * K;
      load_k<K>(s, fb);
      load_k<K>(s + W, fl);
      load_k<K>(s + 2 * W, fa);
#pragma unroll
      for (int q = 0; q < Q; ++q) f.copy(rb, ra, rl, R, T, U1);
""", """      terms(n - 1, fb, fl, fa);
"""),
]

BRANCHY = [
    (None, """  asm volatile(
      "{\\n .reg .pred q;\\n setp.ne.b32 q, %2, 0;\\n @q cp.async.ca.shared.global [%0], [%1], 4;\\n}\\n"
      ::"r"(dst), "l"(src), "r"((int)p));
""", """  if (p) asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(dst), "l"(src));
"""),
    (None, """  asm volatile("{\\n .reg .pred q;\\n setp.ne.b32 q, %2, 0;\\n @q st.global.f32 [%0], %1;\\n}\\n"
               ::"l"(dst), "f"(v), "r"((int)p));
""", "  if (p) *dst = v;\n"),
]

# each design's edits and the ring chunks its plan budgets (None: the
# plan's own, `rnnt_lattice.RING_CHUNKS`)
DESIGNS = {"base": ([], None), "bunched": (BUNCHED, None),
           "output_ring": (OUTPUT_RING, {"alpha": 10, "beta_grad": 16}),
           "no_input_ring": (NO_INPUT_RING, None), "branchy": (BRANCHY, None)}


def _kernel_span(src: str, kernel: str | None) -> tuple[int, int]:
    """The characters of `kernel`'s definition (to the next __global__), or
    the whole source for None."""
    if kernel is None:
        return 0, len(src)
    start = src.index(f"\n{kernel}(")
    end = src.find("__global__", start)
    return start, len(src) if end < 0 else end


def design_sources() -> dict[str, str]:
    """Each design's source: the kernel source with its edits made; an edit
    whose target is not in its kernel exactly once raises."""
    src = (_build.CSRC / "rnnt_lattice.cu").read_text()
    out = {}
    for name, (edits, _) in DESIGNS.items():
        text = src
        for kernel, old, new in edits:
            lo, hi = _kernel_span(text, kernel)
            body = text[lo:hi]
            if body.count(old) != 1:
                raise ValueError(f"design {name}: the edit's target occurs {body.count(old)} "
                                 f"times in {kernel or 'the source'}:\n{old}")
            text = text[:lo] + body.replace(old, new) + text[hi:]
        out[name] = text
    return out


def build(out_dir=None) -> dict[str, ctypes.CDLL]:
    """Build every design (one nvcc each, all started together) and load it."""
    out_dir = out_dir or _build.BUILD_DIR.parent / "rnnt_lattice_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in design_sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for entry in ("rnnt_alpha", "rnnt_beta_grad"):
            getattr(lib, entry).argtypes = _build.ENTRIES[entry][2]
        libs[name] = lib
    return libs


def _plans(u1: int, ring_chunks: dict | None) -> tuple[dict, dict]:
    """The warp route's plans of #8 and #9 at U+1 for a design whose rings
    take `ring_chunks` chunks (None: the kernel's own)."""
    import importlib

    rl = importlib.import_module("tpuasr_torch.ops.rnnt_lattice")
    own = rl.RING_CHUNKS
    rl.RING_CHUNKS = ring_chunks or own
    try:
        return tuple(rl._rnnt_plan(u1, entry, route="warp") for entry in rl.ENTRIES)
    finally:
        rl.RING_CHUNKS = own


def main() -> None:
    import torch

    import chip_smoke as cs
    from tpuasr_torch.ops.rnnt_lattice import rnnt_alpha_plain, rnnt_beta_grad_plain

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build()
    r = np.random.default_rng(cs.SEED)
    t_lens = np.concatenate([[191], r.integers(150, 192, 11)])
    u_lens = np.concatenate([[32], r.integers(26, 33, 11)])
    shapes = {"bench": (191, 33, t_lens, u_lens)}
    for tt in (63, 127):
        shapes[f"T'{tt}"] = (tt, 17, np.minimum(t_lens, tt), np.minimum(u_lens, 16))
    for u1 in (32, 128):
        shapes[f"U+1 {u1}"] = (191, u1, t_lens, np.full(12, u1 - 1))
    readings = {}
    stream = torch.cuda.current_stream().cuda_stream
    for seed, (tag, (t, u1, tl, ul)) in enumerate(shapes.items()):
        a = cs.rnnt_lattice_inputs(torch, dev, 12, t, u1, tl, ul, cs.SEED + 100 + seed)
        bl, lb, uls = a["blank_lp"], a["label_lp"], a["u_lens"]
        b = bl.shape[0]
        ra, rll = rnnt_alpha_plain(bl, lb, uls)
        gv = torch.ones(b, device=dev)
        rgb, rgl = rnnt_beta_grad_plain(bl, lb, uls, ra, rll, gv)
        plans = {name: _plans(u1, chunks) for name, (_, chunks) in DESIGNS.items()}
        al, ll = torch.empty_like(bl), torch.empty(b, device=dev)
        gb, gl = torch.empty_like(bl), torch.empty_like(lb)

        def calls(name):
            lib, (pa, pb) = libs[name], plans[name]
            return {"rnnt_alpha": lambda: lib.rnnt_alpha(
                        bl.data_ptr(), lb.data_ptr(), uls.data_ptr(), al.data_ptr(),
                        ll.data_ptr(), b, t, u1, pa["k"], pa["chunk"], pa["share"], stream),
                    "rnnt_beta_grad": lambda: lib.rnnt_beta_grad(
                        bl.data_ptr(), lb.data_ptr(), uls.data_ptr(), ra.data_ptr(),
                        rll.data_ptr(), gv.data_ptr(), gb.data_ptr(), gl.data_ptr(), b, t, u1,
                        pb["k"], pb["chunk"], pb["share"], stream)}

        held = {}
        for name in libs:
            c = calls(name)
            al.fill_(float("nan")), gb.fill_(float("nan")), gl.fill_(float("nan"))
            cs.require(c["rnnt_alpha"]() == 0 and c["rnnt_beta_grad"]() == 0,
                       f"design {name} refused the launch at {tag}")
            torch.cuda.synchronize()
            live = ra > -1e29
            ok = (torch.equal(live, al > -1e29)
                  and bool(((al - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
                  and bool(((ll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
                  and all(bool(((x - y).abs() <= 2e-3 * y.abs() + 1e-5).all())
                          for x, y in ((gb, rgb), (gl, rgl))))
            held[name] = ok
        for kernel in ("rnnt_alpha", "rnnt_beta_grad"):
            order = list(libs) + list(libs)[::-1]
            ms = {name: [] for name in libs}
            for name in order:
                ms[name].append(cs._time_ms(torch, calls(name)[kernel]))
            readings.setdefault(tag, {})[kernel] = {
                name: {"ms": ms[name], "held": held[name]} for name in libs}
            print(f"{tag} (B 12, T' {t}, U+1 {u1}) {kernel}, ms in turns: " + "; ".join(
                f"{name} {ms[name][0]:.4f} {ms[name][1]:.4f}"
                + ("" if held[name] else " (DISAGREES with plain)") for name in libs))
    print(json.dumps({"rnnt_lattice_designs": readings}))
    if not all(rec["held"] for per in readings.values() for k in per.values()
               for rec in k.values()):
        sys.exit("a design disagrees with the plain versions")


if __name__ == "__main__":
    main()
