#!/usr/bin/env python3
"""Drive the port's three main paths on one NVIDIA GPU at the benchmark
cells' shapes, EfficientNetV2-rw_t at full width, and hold each kernel's
wrapper against its plain torch version on the inputs the path gave it.

    python3 chip_smoke.py

The models, shapes and recipe are read from the benchmark's own files
(`curlbench/configs/`, `curlbench/workloads/`); weights are drawn from seed
0. Each path's launch counts are set to 0 just before its run and read just
after it, before any check launches a kernel again.

  1. Serving (`trispace_d4_rw_t.serve_1080p_b32_dev`): TriSpacePolyNet,
     degree 4, spatial, BN statistics from the first batch's views;
     `Enhancer.enhance_stream` over 3 batches of 32 u8 1920x1080 frames
     already on the card, 4 in flight, u8 out. One K1 launch a batch and
     nothing else. Each K1 call as the path made it (`ops.enhance`'s
     `fused_trispace_residual`) against its plain version on the same
     frames and coefficients: on the u8 wire at least 99.9% of the values
     equal and none more than 1 apart; in fp32, on the first batch, within
     2e-4.
  2. One photo (`curve_rw_t_48_48_64.interactive_1080p_b1`): CurlCurveNet
     at 48/48/64 knots, paper mode, its knot logits scaled to std 0.05;
     `Enhancer.enhance_image` on 4 requests of one pageable numpy 1920x1080
     u8 photo, u8 out, fetched with `.cpu().numpy()`. One K2 launch a
     request and nothing else. Each K2 call (`models.curl_curve`'s
     `fused_curve_enhance`) against its plain version: on the u8 wire at
     least 99.9% of the values equal and all but 1e-5 within 1 level; in
     fp32 all but 1e-5 of the values within 2e-4 (the ten chained curves
     may flip a hue or clip branch where the two round differently).
  3. Training (`trispace_d4_rw_t.train_256_b32`): one step of the
     reference recipe (batch 32 of 256x256, augment off, Adam under
     OneCycle, TF32 off) through K1 and, from a copy with the same weights,
     through the plain path: losses within rel 1e-4, the head's last
     layer's gradient within relative L2 1e-3, BN buffers equal. The
     kernel step launches K1 once, calls K1's backward kernel once and
     never the plain recompute; the plain step launches neither. Every K3
     call (the tie-exact clip's backward) in both steps is bitwise its
     plain version on the same inputs. Then the cell's main path, the
     step's CUDA graph, on the kernel model and the same batch: the second
     call captures it (the wrappers count its K1 launch, its backward
     kernel call and the eager step's K3 calls) and takes one step, the
     third replays it, which no wrapper counts: `train/steps.py`'s
     `STEP_CAPTURES` and `STEP_REPLAYS` move by one each, and torch.profiler
     finds in the replay one K1, one K1 backward kernel and as many K3
     kernels as the eager step launched. Two copies of the state taken
     before the replay each take one eager step on the batch: the replayed
     step's loss, parameters and BN buffers are within twice the gap of the
     two eager ones (or 1e-6, where those agree bitwise), the integer
     buffers equal.

The second-to-last line is the kernels' record, {"kernels": [...]}: for
each of K1, K2, K1's backward and K3, its launches on its path (the
training kernels': in the replayed step), its
distance there from its plain version, and its bound at that path's shape
(`bound_ms`, the least time the H100 SXM's published peaks allow,
`curlbench/counts/`); `library_ms` is null, as no library call stands
beside these kernels. The last line is {"ok": true, "device": ...}. Without
CUDA it exits 2 and prints no result.

Every other shape, degree, knot count and dtype, the gradients, and the
paths around these (CLIs, distribution, bf16, chained graphs, tools) are
the card suite's: `tests/test_torch_cuda.py`, `tests/test_torch_cuda_paths.py`.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
CELLS = {"serve": "trispace_d4_rw_t.serve_1080p_b32_dev",
         "photo": "curve_rw_t_48_48_64.interactive_1080p_b1",
         "train": "trispace_d4_rw_t.train_256_b32"}
SERVE_BATCHES = 3
REQUESTS = 4
PLAIN_CHUNK = 8  # images of 1080p a plain-version call takes at once
KNOT_STD = 0.05  # 16 knots a curve: the steepness K2's contracts are stated at
STEP_LOSS_RTOL = 1e-4
HEAD_GRAD_REL_L2 = 1e-3
GRAPH_FLOOR = 1e-6  # the replayed step's gap where two eager steps agree bitwise
K1_NAME, K1B_NAME, K3_NAME = "trispace_residual_kernel", "trispace_backward_kernel", "tie_clip_grad"


def log(msg: str) -> None:
    print(msg, flush=True)


def cell(name: str) -> tuple[dict, dict]:
    """(configuration, workload parameters) of a benchmark cell."""
    work = json.loads((ROOT / "curlbench" / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((ROOT / "curlbench" / "configs" / f"{work['config']}.json").read_text())
    return cfg, work["params"]


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    from curlbench import counts

    seconds, by = counts.bound_s(flops, nbytes)
    return seconds * 1e3, by


class Launches:
    """Every kernel's launch counter: K1, K2, K3, and K1's backward kernel
    calls (K1B) and plain recomputes (K1P)."""

    def __init__(self):
        from curl_tpu_torch.ops.kernels import clip_kernel, curve_kernel, trispace_kernel

        self.mods = {"K1": (trispace_kernel, "LAUNCHES"), "K2": (curve_kernel, "LAUNCHES"),
                     "K3": (clip_kernel, "LAUNCHES"),
                     "K1B": (trispace_kernel, "BACKWARD_LAUNCHES"),
                     "K1P": (trispace_kernel, "PLAIN_BACKWARDS")}

    def reset(self) -> None:
        for mod, attr in self.mods.values():
            setattr(mod, attr, 0)

    def read(self) -> dict:
        return {k: getattr(mod, attr) for k, (mod, attr) in self.mods.items()}


def expect(n: dict, what: str, **want) -> None:
    got = {k: n[k] for k in n}
    want = {k: want.get(k, 0) for k in n}
    log(f"  launches on the {what}: {got}")
    if got != want:
        raise AssertionError(f"{what}: expected launches {want}, counted {got}")


class Recorder:
    """While active, records each call of `module.name` as the path makes
    it: the image it was given, clones of its other arguments (the
    prediction's CUDA graph writes its outputs into the same buffers at
    every replay), and its result."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls: list = []

    def __enter__(self):
        import torch

        self.fn = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            out = self.fn(*args, **kwargs)
            kept = [args[0]] + [a.clone() if isinstance(a, torch.Tensor) else a
                                for a in args[1:]]
            self.calls.append((kept, kwargs, out))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def kernel_names(fn) -> tuple:
    """(fn(), the names of the CUDA kernels torch.profiler records around
    it). A process's first profiler sessions can come back with no CUDA
    record, so sessions around one known kernel run first until one holds
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def names(f):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = f()
            torch.cuda.synchronize()
        return out, [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]

    if not any(names(lambda: torch.ones(8, device="cuda").add_(1))[1] for _ in range(10)):
        raise AssertionError("torch.profiler records no CUDA kernel")
    return names(fn)


def rel_gap(a: list, b: list) -> float:
    """Relative L2 of two lists of tensors, flattened and joined (float64)."""
    import torch

    x = torch.cat([t.detach().double().reshape(-1) for t in a])
    y = torch.cat([t.detach().double().reshape(-1) for t in b])
    return float((x - y).norm() / y.norm().clamp_min(1e-30))


def u8_agreement(got, plain) -> tuple[float, int, int]:
    """(share of values equal, count more than 1 apart, largest difference)."""
    diff = (got.int() - plain.int()).abs()
    return float((diff == 0).float().mean()), int((diff > 1).sum()), int(diff.max())


def u8_frames(gen, *shape):
    import torch

    return torch.randint(0, 256, shape, generator=gen, device=gen.device, dtype=torch.uint8)


def serve(dev, launches: Launches, kp) -> dict:
    """Path 1. Returns K1's record."""
    import torch

    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.models.backbone import calibrate_batch_norm
    from curl_tpu_torch.ops import enhance, wire
    from curl_tpu_torch.ops.kernels import trispace_kernel as tk

    cfg, p = cell(CELLS["serve"])
    b, h, w, s = p["batch"], p["height"], p["width"], cfg["predict_size"]
    gen = torch.Generator(dev).manual_seed(SEED)
    mask = torch.ones(b, s, s, 1, dtype=torch.uint8, device=dev)
    batches = [(u8_frames(gen, b, s, s, 3), mask, u8_frames(gen, b, h, w, 3))
               for _ in range(SERVE_BATCHES)]
    model = TriSpacePolyNet(cfg["polynomial_order"], cfg["spatial"], cfg["backbone"]["name"],
                            device=dev, generator=torch.Generator().manual_seed(SEED))
    view = batches[0][0].float() / 255.0
    calibrate_batch_norm(model, lambda: model.generate_coefficients(view, mask.float()))
    enh = Enhancer(model, dev, backbone_size=s, out_u8=True)
    launches.reset()
    with Recorder(enhance, "fused_trispace_residual") as rec:
        outs = list(enh.enhance_stream(iter(batches), max_in_flight=p["max_in_flight"]))
        torch.cuda.synchronize()
    expect(launches.read(), "serving path", K1=len(batches))

    same, far, worst, fp32_err = 1.0, 0, 0, 0.0
    for i, ((img, *cs), kw, out) in enumerate(rec.calls):
        if (out.data_ptr(), img.data_ptr()) != (outs[i].data_ptr(), batches[i][2].data_ptr()) or (
                kw.get("tile") is not None):
            raise AssertionError("the recorded K1 call is not the served batch's")
        for j in range(0, b, PLAIN_CHUNK):
            part = slice(j, j + PLAIN_CHUNK)
            c = [x[part] for x in cs]
            plain = tk.fused_trispace_residual_reference(
                img[part], *c, degree=kw["degree"], spatial=kw["spatial"], composite=True)
            eq, n_far, top = u8_agreement(out[part], plain)
            same, far, worst = min(same, eq), far + n_far, max(worst, top)
            if i == 0:
                x = wire.norm_u8(img[part])
                got = tk.fused_trispace_residual(x, *c, degree=kw["degree"],
                                                 spatial=kw["spatial"], composite=True)
                ref = tk.fused_trispace_residual_reference(
                    x, *c, degree=kw["degree"], spatial=kw["spatial"], composite=True)
                fp32_err = max(fp32_err, float((got - ref).abs().max()))
            del plain
    log(f"  K1 against its plain version: u8 equal share {same:.6f}, {far} values more than 1 "
        f"apart, max {worst}; fp32 max abs {fp32_err:.3e} (first batch)")
    if same < kp.U8_SAME_SHARE or far or not fp32_err <= kp.TOL:
        raise AssertionError("K1 disagrees with its plain version on the serving path")
    from curlbench import counts

    ms, by = bound_ms(*counts.apply_counts(cfg, b, h * w, 1))
    return {"name": "fused_trispace_residual", "cell": CELLS["serve"], "launches": len(rec.calls),
            "u8_equal_share": same, "u8_max_diff": worst, "max_abs_err": fp32_err,
            "bound_ms": ms, "bound_by": by, "library_ms": None}


def photo(dev, launches: Launches, kp) -> dict:
    """Path 2. Returns K2's record."""
    import torch

    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.models import CurlCurveNet, curl_curve
    from curl_tpu_torch.models.backbone import calibrate_batch_norm
    from curl_tpu_torch.ops import wire
    from curl_tpu_torch.ops.kernels import curve_kernel as ck

    cfg, p = cell(CELLS["photo"])
    h, w, s = p["height"], p["width"], cfg["predict_size"]
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    views, targets = u8_frames(gen, REQUESTS, s, s, 3), u8_frames(gen, REQUESTS, h, w, 3)
    model = CurlCurveNet(*cfg["knots"], backbone=cfg["backbone"]["name"],
                         curve_mode=cfg["curve_mode"], device=dev,
                         generator=torch.Generator().manual_seed(SEED))
    view = views.float() / 255.0
    calibrate_batch_norm(model, lambda: model.predict_knots(view))
    with torch.inference_mode():
        std = float(model.predict_knots(view).std())
    with torch.no_grad():  # the classifier's bias is zero: this scales the logits
        model.backbone.classifier.weight.mul_(KNOT_STD / std)
    log(f"  knot logit std {std:.4f}, scaled to {KNOT_STD}")
    enh = Enhancer(model, dev, backbone_size=s, out_u8=True)
    mask = np.ones((1, s, s, 1), np.uint8)
    requests = [(views[i:i + 1].cpu().numpy(), mask, targets[i:i + 1].cpu().numpy())
                for i in range(REQUESTS)]
    launches.reset()
    with Recorder(curl_curve, "fused_curve_enhance") as rec:
        outs = [enh.enhance_image(*r).cpu().numpy() for r in requests]
    expect(launches.read(), "one-photo path", K2=len(requests))

    same, far, off, values = 1.0, 0, 0, 0
    for i, ((img, mask_arg, *knots), _, out) in enumerate(rec.calls):
        if mask_arg is not None or not np.array_equal(out.cpu().numpy(), outs[i]):
            raise AssertionError("the recorded K2 call is not the served photo's")
        eq, n_far, _ = u8_agreement(out, ck.fused_curve_enhance_reference(img, None, *knots))
        same, far = min(same, eq), far + n_far
        x = wire.norm_u8(img)
        err = (ck.fused_curve_enhance(x, None, *knots)
               - ck.fused_curve_enhance_reference(x, None, *knots)).abs()
        off, values = off + int((err > kp.TOL).sum()), values + err.numel()
    log(f"  K2 against its plain version: u8 equal share {same:.6f}, {far} values more than 1 "
        f"apart; fp32 {off} of {values} values past {kp.TOL}")
    if same < kp.U8_SAME_SHARE or far > kp.CURVE_FLIP_SHARE * values or (
            off > kp.CURVE_FLIP_SHARE * values):
        raise AssertionError("K2 disagrees with its plain version on the one-photo path")
    from curlbench import counts

    ms, by = bound_ms(*counts.apply_counts(cfg, 1, h * w, 1))
    return {"name": "fused_curve_enhance", "cell": CELLS["photo"], "launches": len(rec.calls),
            "u8_equal_share": same, "fp32_share_off": off / values,
            "bound_ms": ms, "bound_by": by, "library_ms": None}


def train(dev, launches: Launches, kp) -> list:
    """Path 3. Returns the records of K1's backward and of K3."""
    import torch

    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.ops.kernels import clip_kernel as clk
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    cfg, p = cell(CELLS["train"])
    b, crop, r = p["batch"], p["crop"], p["recipe"]
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    batch = {"input_img": u8_frames(gen, b, crop, crop, 3),
             "output_img": u8_frames(gen, b, crop, crop, 3),
             "mask": (torch.rand(b, crop, crop, 1, generator=gen, device=dev) < 0.9)
             .to(torch.uint8)}
    kernel_model = TriSpacePolyNet(cfg["polynomial_order"], cfg["spatial"],
                                   cfg["backbone"]["name"], device=dev,
                                   generator=torch.Generator().manual_seed(SEED))
    plain_model = copy.deepcopy(kernel_model)
    plain_model.residual_impl = "torch"
    step = steps_lib.make_train_step(ssim_window=r["ssim_window"], augment=False)
    k3 = {"calls": 0, "values": 0, "unequal": 0}
    plain_clip = clk.tie_clip_grad

    def clip_checked(g, x, lo, hi):
        out = plain_clip(g, x, lo, hi)
        k3["calls"] += 1
        k3["values"] += x.numel()
        k3["unequal"] += not torch.equal(out, clk.tie_clip_grad_reference(g, x, lo, hi))
        return out

    results, states = [], []
    clk.tie_clip_grad = clip_checked
    try:
        for model in (kernel_model, plain_model):
            state = state_lib.TrainState(model, state_lib.make_optimizer(
                model.parameters(),
                state_lib.onecycle_schedule(r["epochs"], r["steps_per_epoch"], r["peak_lr"]),
                r["adam_b1"], r["adam_b2"]))
            states.append(state)
            launches.reset()
            loss = float(step(state, batch, torch.Generator(device=dev))["loss"])
            torch.cuda.synchronize()
            n = launches.read()
            head = [m for m in model.backbone.classifier.modules()
                    if isinstance(m, torch.nn.Linear)][-1]
            buffers = {k: v for k, v in model.state_dict().items()
                       if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
            results.append((loss, head.weight.grad, buffers, n))
    finally:
        clk.tie_clip_grad = plain_clip
    (k_loss, k_grad, k_buf, k_n), (p_loss, p_grad, p_buf, p_n) = results
    expect(k_n, "kernel step", K1=1, K1B=1, K3=k_n["K3"])
    expect(p_n, "plain step", K3=p_n["K3"])
    rel = float((k_grad - p_grad).norm() / p_grad.norm())
    same_buffers = all(torch.equal(k_buf[k], p_buf[k]) for k in k_buf)
    log(f"  kernel step loss {k_loss:.7f}, plain {p_loss:.7f}; last layer's gradient relative "
        f"L2 {rel:.2e}; {len(k_buf)} BN buffers equal: {same_buffers}; K3 {k3['calls']} calls "
        f"over {k3['values']} values, {k3['unequal']} not bitwise its plain version")
    if not (np.isfinite(k_loss) and abs(k_loss - p_loss) <= STEP_LOSS_RTOL * abs(p_loss)):
        raise AssertionError("the kernel step's loss disagrees with the plain step's")
    if rel > HEAD_GRAD_REL_L2 or not same_buffers:
        raise AssertionError("the kernel step's gradient or BN buffers disagree")
    if min(k_n["K3"], p_n["K3"]) == 0 or k3["unequal"]:
        raise AssertionError("K3 is not launched in both steps, or differs from its plain version")
    replay_n = replay(step, states[0], batch, launches, k_n["K3"])
    pixels = b * crop * crop
    # K1's backward reads the fp32 image and the upstream gradient once.
    bwd_ms, bwd_by = bound_ms(kp.BACKWARD_FLOP_PER_PIXEL * pixels, 2 * 12 * pixels)
    clip_ms, clip_by = bound_ms(0.0, 12 * k3["values"])  # gradient and input read, one written
    return [{"name": "trispace_backward", "cell": CELLS["train"], "launches": replay_n[K1B_NAME],
             "plain_recomputes": k_n["K1P"], "head_grad_rel_l2": rel,
             "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
             "bound_ms": bwd_ms, "bound_by": bwd_by, "library_ms": None},
            {"name": "tie_clip_grad", "cell": CELLS["train"], "launches": replay_n[K3_NAME],
             "values": k3["values"], "bitwise": True,
             "bound_ms": clip_ms, "bound_by": clip_by, "library_ms": None}]


def replay(step, state, batch, launches: Launches, eager_k3: int) -> dict:
    """Path 3's main path: the step's CUDA graph on `state`, whose first
    call of this signature ran eagerly. Returns the kernels counted in the
    replayed step, by name."""
    import torch

    from curl_tpu_torch.train import steps as steps_lib

    def counters():
        return steps_lib.STEP_CAPTURES, steps_lib.STEP_REPLAYS, steps_lib.STEP_EAGER

    before = counters()
    launches.reset()
    captured = float(step(state, batch, None)["loss"])
    torch.cuda.synchronize()
    expect(launches.read(), "capture", K1=1, K1B=1, K3=eager_k3)
    twins = [copy.deepcopy(state) for _ in range(2)]
    launches.reset()
    loss, names = kernel_names(lambda: float(step(state, batch, None)["loss"]))
    expect(launches.read(), "replay (no wrapper runs)")
    moved = tuple(b - a for a, b in zip(before, counters()))
    n = {name: sum(name in k for k in names) for name in (K1_NAME, K1B_NAME, K3_NAME)}
    log(f"  captured and replayed steps: losses {captured:.7f}, {loss:.7f}; captures, replays, "
        f"eager steps {moved}; kernels in the replay {n} of {len(names)}")
    if moved != (1, 1, 0) or not np.isfinite([captured, loss]).all():
        raise AssertionError("the third step of a signature does not replay its capture")
    if n != {K1_NAME: 1, K1B_NAME: 1, K3_NAME: eager_k3}:
        raise AssertionError(f"the replay's kernels are not the eager step's: {n}")

    eager = []
    for twin in twins:
        twin_loss = step(twin, batch, None)["loss"]
        eager.append({"loss": [twin_loss.reshape(1).cpu()], "params": list(twin.model.parameters()),
                      "buffers": list(twin.model.buffers())})
    got = {"loss": [torch.tensor([loss])],
           "params": list(state.model.parameters()), "buffers": list(state.model.buffers())}
    a, b = eager
    gaps = {}
    for key in got:
        floats = [i for i, t in enumerate(a[key]) if t.is_floating_point()]
        gaps[key] = tuple(rel_gap([x[key][i] for i in floats], [a[key][i] for i in floats])
                          for x in (got, b))
    same_ints = all(torch.equal(x, y) for x, y in zip(got["buffers"], a["buffers"])
                    if not x.is_floating_point())
    log("  replayed step against an eager one (relative L2; two eager steps' gap): "
        + ", ".join(f"{k} {g:.2e} ({e:.2e})" for k, (g, e) in gaps.items())
        + f"; integer buffers equal: {same_ints}")
    if any(g > max(2 * e, GRAPH_FLOOR) for g, e in gaps.values()) or not same_ints:
        raise AssertionError("the replayed step disagrees with an eager step from its state")
    return n


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from curl_tpu_torch.config import Config, apply_precision
    from curl_tpu_torch.tools import kernel_probe as kp

    card = kp.card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    apply_precision(Config.matmul_precision)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("matmul TF32 must stay off (the degree-4 polynomial amplifies it)")
    dev = torch.device("cuda")
    launches = Launches()
    kernels = []
    for name, path in (("serve", serve), ("photo", photo), ("train", train)):
        log(f"{name}: {CELLS[name]}")
        got = path(dev, launches, kp)
        kernels += got if isinstance(got, list) else [got]
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
