#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the main paths' shapes (K = P = 10, Q = M = 100, D = 595,914)
   and at edge shapes, and times the kernel, the plain version and one
   PyTorch library call computing the same function (CUDA events, L2
   flushed before every launch), beside the least time the card could take.
   ``topk_mask_rows`` must equal its plain version bitwise, ties, NaN, ±inf
   and -0.0 included.
3. Main path: the paper's CIFAR-10 model (§4.1 2conv+3fc, D = 595,914) in a
   100-client federation, 6 FLrce rounds through ``run_federated`` on the
   card.  Every kernel's launch count is reset just before the run and read
   just after; each kernel of the path must have run on it.
   Then 3 more rounds run under ``torch.profiler``: the device time by
   kernel and the device's busy share of the wall time are printed.
4. Baselines (§4.1) on the same federation at full width: 4 Fedcom rounds
   (``topk_mask_rows`` once per round), 4 FedAvg rounds and 2 rounds each
   of Fedprox, Dropout, TimelyFL, PyramidFL and QuantizedFL, each with the
   launch counts reset just before and read just after, and the time of
   QuantizedFL's host-drawn rounding uniforms.
5. Reference check: small federations (FLrce, Fedcom) run on the card and on
   the CPU (the kernels' plain versions) must make the same selections,
   exploit flags, stop decision and ledger charges, with accuracies and
   losses within fp32 tolerance.

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
# read before every timed launch: far more than the 50 MB L2, and long
# enough (about 0.3 ms) that the host has queued the timed call before the
# card reaches it, on a slow host too
L2_FLUSH_BYTES = 1 << 30
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

    The calls are queued without a synchronise in between: the 1 GiB flush
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


def check_bitwise(name, got, want, torch) -> None:
    """Equal bit patterns (so -0.0 and where NaN sits are checked too)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if not torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)):
        fail(f"{name}: kernel and plain version differ bitwise")


def topk_inputs(torch, gen) -> list:
    """(label, u) pairs: normal values at the main and edge shapes, ties from
    a small integer set, and NaN / ±inf / -0.0 mixed in."""
    out = [(f"P={p} D={d}", torch.randn(p, d, generator=gen, device="cuda"))
           for p, d in [(10, 1), (10, 2047), (10, 2049), (1, D_MAIN), (17, 5000), (K_MAIN, D_MAIN)]]
    ties = torch.randint(-3, 4, (K_MAIN, 8193), generator=gen, device="cuda").float()
    special = torch.randn(K_MAIN, 8195, generator=gen, device="cuda")
    pick = torch.randint(0, 8, special.shape, generator=gen, device="cuda")
    for code, value in ((0, float("nan")), (1, float("inf")), (2, float("-inf")), (3, -0.0)):
        special = torch.where(pick == code, torch.full_like(special, value), special)
    special[0] = float("nan")
    special[1, :2048] = -0.0
    return out + [("ties P=10 D=8193", ties), ("nan/inf/-0 P=10 D=8195", special)]


def kernel_phase(torch, timer, bandwidth) -> dict:
    from repro_torch.kernels import aggregate as kagg
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import topk_mask as ktopk

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
    for label, u in topk_inputs(torch, gen):
        for keep_frac in (0.001, 0.1, 0.5, 1.0):
            check_bitwise(f"topk_mask_rows {label} keep_frac={keep_frac}",
                          ktopk.topk_mask_rows_cuda(u, keep_frac=keep_frac),
                          ktopk.topk_mask_rows_plain(u, keep_frac=keep_frac), torch)
        print(f"  topk_mask_rows {label}: bitwise equal at keep_frac 0.001, 0.1, 0.5, 1.0")

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
    kf, bd = 0.1, ktopk.DEFAULT_BLOCK_D
    k_keep = ktopk.keep_count(kf, bd)
    check_bitwise("topk_mask_rows main", ktopk.topk_mask_rows_cuda(u, keep_frac=kf),
                  ktopk.topk_mask_rows_plain(u, keep_frac=kf), torch)
    padded = torch.nn.functional.pad(u, (0, (-d) % bd)).reshape(-1, bd)

    def library_route():
        mag = padded.abs()
        kth = torch.topk(mag, k_keep, dim=1).values[:, k_keep - 1:]
        return torch.where(mag >= kth, padded, 0.0)

    # the selection's data-dependent work is counted as one compare per
    # element per pattern bit of the radix select (31 bits)
    b_ms, b_by = bound(4 * (k * d + k * d), 31 * k * d)
    rows.append(dict(
        name="topk_mask_rows", route="cuda", source="src/repro_torch/kernels/csrc/topk_mask.cu",
        replaces="src/repro/kernels/topk_mask.py:38", max_abs_err=0.0, rel_err=0.0,
        ms=timer(lambda: ktopk.topk_mask_rows_cuda(u, keep_frac=kf)),
        plain_ms=timer(lambda: ktopk.topk_mask_rows_plain(u, keep_frac=kf)),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call computes it; the two-call route below is
        # printed and kept in PERF.md, not in the JSON line
        library_ms=None, route_ms=timer(library_route),
        shape=f"P={k} D={d} keep_frac={kf}",
    ))
    for r in rows:
        lib = (f"library {r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"torch.topk+torch.where (two calls) {r['route_ms']:.4f} ms")
        print(f"  {r['name']:<18} {r['shape']:<22} max|Δ| {r['max_abs_err']:.3e}  "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"{lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"-> {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    del u, v, w, padded
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
    if launches["topk_mask_rows"] != 0:
        fail(f"topk_mask_rows launched {launches['topk_mask_rows']} times on the FLrce path")
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


def run_baseline(torch, name, rounds, ds, model, params, **kw):
    """One full-width baseline job, its launch counts read just after."""
    from repro_torch.fl import baselines, run_federated
    from repro_torch.kernels import ops

    strategy = getattr(baselines, name)(100, 10, 2, seed=0, **kw)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_federated(model, ds, strategy, max_rounds=rounds, learning_rate=MAIN_LR, batch_size=32,
                        seed=0, init_params=params, torch_device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"cross_gram": 0, "gram": 0, "weighted_aggregate": rounds,
            "topk_mask_rows": rounds if name == "Fedcom" else 0}
    if launches != want:
        fail(f"{name}: launches {launches}, want {want}")
    if res.rounds_run != rounds:
        fail(f"{name}: ran {res.rounds_run} of {rounds} rounds")
    for r in res.records:
        if not (math.isfinite(r.accuracy) and math.isfinite(r.mean_client_loss)):
            fail(f"{name} round {r.t}: non-finite accuracy/loss")
        if len(r.selected) != 10 or len(set(r.selected)) != 10:
            fail(f"{name} round {r.t}: bad selection {r.selected}")
    for pname, prm in res.final_params.items():
        if not torch.isfinite(prm).all():
            fail(f"{name}: final params {pname} not finite")
    summary = {k: v for k, v in res.summary().items() if k != "stopped_early"}
    print(f"  {name:<11} per-round wall " + ", ".join(f"{r.wall_s:.3f}" for r in res.records)
          + f" s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}")
    print(f"  {name:<11} summary {json.dumps(summary)}")
    return res, launches, strategy


def baselines_phase(torch, ds, model, params) -> dict:
    """Every §4.1 baseline at full width; Fedcom is the top-k kernel's path."""
    import numpy as np

    runs = {}
    for name, rounds, kw in [("Fedcom", 4, dict(keep_frac=0.1)), ("FedAvg", 4, {}),
                             ("Fedprox", 2, {}), ("Dropout", 2, dict(keep_rate=0.5)),
                             ("TimelyFL", 2, {}), ("PyramidFL", 2, {}), ("QuantizedFL", 2, {})]:
        runs[name] = run_baseline(torch, name, rounds, ds, model, params, **kw)
    # QuantizedFL's stochastic-rounding uniforms are drawn on the host
    strategy = runs["QuantizedFL"][2]
    sizes = [p.numel() for p in params.values()]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    ids = np.asarray(runs["QuantizedFL"][0].records[-1].selected)
    t0 = time.perf_counter()
    unif = strategy.rounding_uniforms(1, ids, offsets)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.from_numpy(unif).to("cuda")
    torch.cuda.synchronize()
    print(f"  QuantizedFL host Threefry uniforms: {unif.size} draws in {draw_s:.3f} s, "
          f"copy to the card {time.perf_counter() - t0:.3f} s (per round)")

    def steady(name):
        walls = sorted(r.wall_s for r in runs[name][0].records[1:])
        return walls[len(walls) // 2]

    print(f"  steady round wall (median after round 0): Fedcom {steady('Fedcom'):.3f} s, "
          f"FedAvg {steady('FedAvg'):.3f} s")
    return runs["Fedcom"][1]


def reference_check(torch) -> None:
    """The same small federations on the card (kernels) and on the CPU (plain)."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.fl.baselines import Fedcom
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=8, alpha=0.1, num_samples=600, num_eval=200,
                                       feature_dim=10, num_classes=4, seed=3)
    model = MLPClassifier(10, 4, (16,))
    init = model.init(0, "cpu")
    dim = sum(p.numel() for p in init.values())
    for label, make in (
        ("FLrce", lambda: FLrce(8, 3, 2, dim=dim, es_threshold=10.0, explore_decay=0.5, seed=0)),
        ("Fedcom", lambda: Fedcom(8, 3, 2, seed=0, keep_frac=0.1)),
    ):
        runs = {dev: run_federated(model, ds, make(), max_rounds=6, learning_rate=0.1, batch_size=16,
                                   seed=0, init_params=init, torch_device=dev)
                for dev in ("cuda", "cpu")}
        compare_runs(label, runs["cuda"], runs["cpu"])


def compare_runs(label, a, b) -> None:
    if a.rounds_run != b.rounds_run or a.stopped_early != b.stopped_early:
        fail(f"{label}: GPU and CPU runs differ in length or stop")
    for ra, rb in zip(a.records, b.records):
        same = (ra.selected == rb.selected and ra.exploited == rb.exploited
                and ra.stopped == rb.stopped and ra.energy_kj == rb.energy_kj
                and ra.bytes_gb == rb.bytes_gb)
        if not same:
            fail(f"{label} round {ra.t}: GPU/CPU discrete results differ: {ra} vs {rb}")
        if abs(ra.accuracy - rb.accuracy) > 2e-3 or abs(ra.mean_client_loss - rb.mean_client_loss) > 1e-4:
            fail(f"{label} round {ra.t}: GPU/CPU accuracy or loss differ: {ra} vs {rb}")
    print(f"  small {label} federation GPU == CPU over {a.rounds_run} rounds: selections "
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

    print("phase 2b: the §4.1 baselines at full width, M=100, P=10")
    topk_launches = baselines_phase(torch, ds, model, params)
    launches["topk_mask_rows"] = topk_launches["topk_mask_rows"]
    del ds, model, params

    print("phase 3: small federations, GPU against CPU")
    reference_check(torch)

    kernels = []
    for name in ("cross_gram", "gram", "weighted_aggregate", "topk_mask_rows"):
        r = rows[name]
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            # topk_mask_rows: its path is the Fedcom run; the others: FLrce's
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
