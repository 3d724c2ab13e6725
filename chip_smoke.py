#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the main path's shapes (K = P = 10, Q = M = 100, D = 595,914)
   and at edge shapes, and times the kernel, the plain version and one
   PyTorch library call computing the same function (CUDA events, L2
   flushed before every launch), beside the least time the card could take.
3. Main path: the paper's CIFAR-10 model (§4.1 2conv+3fc, D = 595,914) in a
   100-client federation, 6 FLrce rounds through ``run_federated`` on the
   card.  Every kernel's launch count is reset just before the run and read
   just after; each kernel must have run on that path.
   Then 3 more rounds run under ``torch.profiler``: the device time by
   kernel and the device's busy share of the wall time are printed.
4. Reference check: a small federation run on the card and on the CPU (the
   kernels' plain versions) must make the same selections, exploit flags,
   stop decision and ledger charges, with accuracies and losses within fp32
   tolerance.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so the exit code is
non-zero and no result line is printed.  Exits 1 when CUDA is absent or the
port's sources are not beside this file.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# main-path shapes: the cohort (K = P), the fleet (Q = M), PaperCNN's flat dim
K_MAIN, Q_MAIN, D_MAIN = 10, 100, 595_914
GRAM_RTOL = 1e-4           # |Δ| ≤ 1e-4·‖u_k‖‖v_j‖: fp32 sums over D reordered
AGG_ATOL = AGG_RTOL = 1e-6
FP32_PEAK_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores (data sheet)
L2_FLUSH_BYTES = 256 << 20
# 0.05 diverges on this data: the JAX package's run of the same
# configuration, like the port's, reaches a NaN loss in round 1.
MAIN_LR = 0.01


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def memory_bandwidth(torch) -> tuple:
    """Peak device-memory bytes/s from the memory clock and bus width the
    driver reports (HBM moves two words per clock), else the H100 SXM data
    sheet's 3.35 TB/s."""
    props = torch.cuda.get_device_properties(0)
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    if clock_khz and bus_bits:
        return 2.0 * clock_khz * 1e3 * bus_bits / 8, "memory clock x bus width"
    return 3.35e12, "H100 SXM data sheet"


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each.

    The calls are queued without a synchronise in between: the 256 MB flush
    keeps the card busy while the host runs the next wrapper, so the events
    time the device's work and not the host's launch overhead.  The flush
    reads its buffer, so it leaves clean lines in L2 and the timed call pays
    no write-back of the flush's own data.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(start.elapsed_time(end) for start, end in pairs)
        return times[len(times) // 2]


def check_gram(name, got, want, u, v, torch) -> tuple:
    """(max |Δ|, max |Δ| / (‖u_k‖‖v_j‖)); fails above GRAM_RTOL."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    scale = torch.linalg.vector_norm(u, dim=1)[:, None] * torch.linalg.vector_norm(v, dim=1)[None, :]
    err = (got - want).abs()
    rel = float((err / scale.clamp_min(1e-30)).max())
    if rel > GRAM_RTOL:
        fail(f"{name}: |Δ|/(‖u‖‖v‖) = {rel:.3e} > {GRAM_RTOL:.0e}")
    return float(err.max()), rel


def check_aggregate(name, got, want, torch) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bad = err > AGG_ATOL + AGG_RTOL * want.abs()
    if bool(bad.any()) or not torch.isfinite(got).all():
        fail(f"{name}: max |Δ| = {float(err.max()):.3e} beyond atol/rtol {AGG_ATOL:.0e}")
    return float(err.max())


def kernel_phase(torch, timer, bandwidth) -> dict:
    from repro_torch.kernels import aggregate as kagg
    from repro_torch.kernels import gram as kgram

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    # edge shapes: D = 1, ragged D, K = 1, Q = 1, K over one 16-row tile,
    # Q not a multiple of the 32-row tile, 16-byte-aligned D
    for k, q, d in [(10, 100, 1), (10, 100, 2049), (1, 100, D_MAIN), (10, 1, D_MAIN),
                    (1, 1, 1), (17, 33, 5000), (10, 100, 4096)]:
        u, v = randn(k, d), randn(q, d)
        _, rel = check_gram(f"cross_gram K={k} Q={q} D={d}",
                            kgram.cross_gram_cuda(u, v), kgram.cross_gram_plain(u, v), u, v, torch)
        print(f"  cross_gram edge K={k:3d} Q={q:3d} D={d:7d}: max |Δ|/(‖u‖‖v‖) {rel:.2e}")
    for p, d in [(10, 1), (10, 2049), (1, D_MAIN), (17, 5000), (10, 4096)]:
        u = randn(p, d)
        _, rel = check_gram(f"gram P={p} D={d}", kgram.gram_cuda(u), kgram.gram_plain(u), u, u, torch)
        print(f"  gram edge P={p:3d} D={d:7d}: max |Δ|/(‖u‖‖u‖) {rel:.2e}")
    for p, d in [(10, 1), (10, 2049), (1, D_MAIN), (10, 4096), (3, 7)]:
        w, u, pw = randn(d), randn(p, d), torch.rand(p, generator=gen, device="cuda")
        err = check_aggregate(f"weighted_aggregate P={p} D={d}", kagg.weighted_aggregate_cuda(w, u, pw),
                              kagg.weighted_aggregate_plain(w, u, pw), torch)
        print(f"  weighted_aggregate edge P={p:3d} D={d:7d}: max |Δ| {err:.2e}")

    k, q, d = K_MAIN, Q_MAIN, D_MAIN
    u, v = randn(k, d), randn(q, d)
    w, pw = randn(d), torch.rand(k, generator=gen, device="cuda")
    pw = pw / pw.sum()

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bandwidth, flops / FP32_PEAK_FLOPS
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    rows = []
    err, rel = check_gram("cross_gram main", kgram.cross_gram_cuda(u, v), kgram.cross_gram_plain(u, v),
                          u, v, torch)
    b_ms, b_by = bound(4 * (k * d + q * d + k * q), 2 * k * q * d)
    rows.append(dict(
        name="cross_gram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:98", max_abs_err=err, rel_err=rel,
        ms=timer(lambda: kgram.cross_gram_cuda(u, v)),
        plain_ms=timer(lambda: kgram.cross_gram_plain(u, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.mm(u, v.t())),
        shape=f"K={k} Q={q} D={d}",
    ))
    err, rel = check_gram("gram main", kgram.gram_cuda(u), kgram.gram_plain(u), u, u, torch)
    b_ms, b_by = bound(4 * (k * d + k * k), 2 * k * k * d)
    rows.append(dict(
        name="gram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:56", max_abs_err=err, rel_err=rel,
        ms=timer(lambda: kgram.gram_cuda(u)),
        plain_ms=timer(lambda: kgram.gram_plain(u)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.mm(u, u.t())),
        shape=f"P={k} D={d}",
    ))
    err = check_aggregate("weighted_aggregate main", kagg.weighted_aggregate_cuda(w, u, pw),
                          kagg.weighted_aggregate_plain(w, u, pw), torch)
    b_ms, b_by = bound(4 * (d + k * d + k + d), 2 * k * d)
    rows.append(dict(
        name="weighted_aggregate", route="cuda", source="src/repro_torch/kernels/csrc/aggregate.cu",
        replaces="src/repro/kernels/aggregate.py:37", max_abs_err=err, rel_err=err,
        ms=timer(lambda: kagg.weighted_aggregate_cuda(w, u, pw)),
        plain_ms=timer(lambda: kagg.weighted_aggregate_plain(w, u, pw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: torch.addmv(w, u.t(), pw)),
        shape=f"P={k} D={d}",
    ))
    for r in rows:
        print(f"  {r['name']:<18} {r['shape']:<22} max|Δ| {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"-> {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    del u, v, w
    torch.cuda.empty_cache()
    return {r["name"]: r for r in rows}


def main_path(torch) -> dict:
    from repro_torch.data import make_image_like
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops
    from repro_torch.models import PaperCNN

    t0 = time.perf_counter()
    ds = make_image_like(num_clients=100, alpha=0.1, num_samples=40_000, num_eval=4_000,
                         side=32, channels=3, num_classes=10, seed=0)
    model = PaperCNN(side=32, channels=3, num_classes=10, num_fc=3)
    params = model.init(0, "cuda")
    dim = sum(p.numel() for p in params.values())
    if dim != D_MAIN:
        fail(f"PaperCNN CIFAR flat dim {dim} != {D_MAIN}")
    strategy = FLrce(100, 10, local_epochs=2, dim=dim, es_threshold=5.0, explore_decay=0.5, seed=0)
    print(f"  data + model set-up: {time.perf_counter() - t0:.1f} s (M=100, N=40000, D={dim})")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_federated(model, ds, strategy, max_rounds=6, learning_rate=MAIN_LR, batch_size=32,
                        seed=0, init_params=params, verbose=True, torch_device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    rounds = res.rounds_run
    exploit_rounds = sum(r.exploited for r in res.records)
    print(f"  {rounds} rounds in {wall:.2f} s; per-round wall "
          + ", ".join(f"{r.wall_s:.3f}" for r in res.records) + " s")
    print(f"  summary {json.dumps(res.summary())}")
    print(f"  selections {[r.selected for r in res.records]}")
    print(f"  exploited {[r.exploited for r in res.records]}; launches {launches}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["cross_gram"] != 2 * rounds:
        fail(f"cross_gram launched {launches['cross_gram']} times in {rounds} rounds (want 2 per round)")
    if launches["weighted_aggregate"] != rounds:
        fail(f"weighted_aggregate launched {launches['weighted_aggregate']} times in {rounds} rounds")
    if launches["gram"] != exploit_rounds or exploit_rounds == 0:
        fail(f"gram launched {launches['gram']} times over {exploit_rounds} exploit rounds (want > 0)")
    for r in res.records:
        if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)):
            fail(f"round {r.t}: non-finite accuracy/loss")
        if len(r.selected) != 10 or len(set(r.selected)) != 10:
            fail(f"round {r.t}: bad selection {r.selected}")
    for name, p in res.final_params.items():
        if not torch.isfinite(p).all():
            fail(f"final params {name} not finite")
    state = strategy.server.state
    if tuple(state.updates.shape) != (100, D_MAIN) or not torch.isfinite(state.omega).all():
        fail("server state has the wrong shape or non-finite relationship map")
    if rounds != 6 and not res.stopped_early:
        fail(f"ran {rounds} rounds without stopping")
    steady = sorted(r.wall_s for r in res.records[1:])
    return launches, (ds, model, params, steady[len(steady) // 2])


def profile_phase(torch, ds, model, params, round_wall_s: float, rounds: int = 3) -> None:
    """Where a warm round's time goes: a few more rounds of the main path
    under torch.profiler (the run before has warmed cuDNN and the kernel
    library), device time by kernel and the device's busy time per round.
    The profiler's host overhead inflates its own wall time, so the busy
    share is taken against ``round_wall_s``, the unprofiled run's median
    round after the first."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import FLrce, run_federated

    strategy = FLrce(100, 10, local_epochs=2, dim=D_MAIN, es_threshold=5.0, explore_decay=0.5,
                     seed=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(model, ds, strategy, max_rounds=rounds, learning_rate=MAIN_LR,
                      batch_size=32, seed=1, init_params=params, torch_device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("the profiler saw no device activity")
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, last_end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    # activities can overlap (their summed time exceeds the union), so the
    # shares below are of the summed device time, and busy is the union
    total_us = sum(by_name.values())
    busy_round_s = busy_us / 1e6 / rounds
    print(f"  {rounds} rounds under the profiler: wall {wall_us / 1e6:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s (summed {total_us / 1e6:.3f} s), "
          f"{len(events)} device activities; busy per round "
          f"{busy_round_s:.3f} s = {100 * busy_round_s / round_wall_s:.1f}% of the unprofiled "
          f"median round ({round_wall_s:.3f} s)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / rounds:9.3f} ms/round  {100 * us / total_us:5.1f}%  {name[:110]}")
    for name in ("xgram_partial_kernel", "sum_splits_kernel", "aggregate_kernel"):
        us = sum(t for n, t in by_name.items() if name in n)
        print(f"  {us / 1e3 / rounds:9.3f} ms/round  {100 * us / total_us:5.1f}%  {name} (this port)")


def reference_check(torch) -> None:
    """The same small federation on the card (kernels) and on the CPU (plain)."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=8, alpha=0.1, num_samples=600, num_eval=200,
                                       feature_dim=10, num_classes=4, seed=3)
    model = MLPClassifier(10, 4, (16,))
    init = model.init(0, "cpu")
    dim = sum(p.numel() for p in init.values())
    runs = {}
    for dev in ("cuda", "cpu"):
        strat = FLrce(8, 3, 2, dim=dim, es_threshold=10.0, explore_decay=0.5, seed=0)
        runs[dev] = run_federated(model, ds, strat, max_rounds=6, learning_rate=0.1, batch_size=16,
                                  seed=0, init_params=init, torch_device=dev)
    a, b = runs["cuda"], runs["cpu"]
    if a.rounds_run != b.rounds_run or a.stopped_early != b.stopped_early:
        fail("GPU and CPU runs differ in length or stop")
    for ra, rb in zip(a.records, b.records):
        same = (ra.selected == rb.selected and ra.exploited == rb.exploited
                and ra.stopped == rb.stopped and ra.energy_kj == rb.energy_kj
                and ra.bytes_gb == rb.bytes_gb)
        if not same:
            fail(f"round {ra.t}: GPU/CPU discrete results differ: {ra} vs {rb}")
        if abs(ra.accuracy - rb.accuracy) > 2e-3 or abs(ra.mean_client_loss - rb.mean_client_loss) > 1e-4:
            fail(f"round {ra.t}: GPU/CPU accuracy or loss differ: {ra} vs {rb}")
    print(f"  small federation GPU == CPU over {a.rounds_run} rounds: selections "
          f"{[r.selected for r in a.records]}, exploited {[r.exploited for r in a.records]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    resolve_device("cuda")
    print(gpu_identity())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    info = build.BUILD_INFO
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if info.get('built') else 'cached'}) -> {info['path']}")
    for line in str(info.get("log", "")).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    bandwidth, bw_src = memory_bandwidth(torch)
    print(f"memory bandwidth {bandwidth / 1e12:.3f} TB/s ({bw_src}); "
          f"fp32 peak {FP32_PEAK_FLOPS / 1e12:.0f} TFLOP/s")

    print("phase 1: kernels against their plain versions")
    timer = Timer(torch)
    rows = kernel_phase(torch, timer, bandwidth)
    del timer
    torch.cuda.empty_cache()

    print("phase 2: main path, CIFAR-10 PaperCNN, M=100, P=10, 6 FLrce rounds")
    launches, (ds, model, params, round_wall_s) = main_path(torch)
    print("profile: the main path's device time by kernel")
    profile_phase(torch, ds, model, params, round_wall_s)
    del ds, model, params

    print("phase 3: small federation, GPU against CPU")
    reference_check(torch)

    kernels = []
    for name in ("cross_gram", "gram", "weighted_aggregate"):
        r = rows[name]
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
