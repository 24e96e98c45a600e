#!/usr/bin/env python3
"""Drive the PyTorch port's UL-SCH transmitter and PUSCH receiver on an
NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or PATH) and this checkout; imports
nothing of JAX.  Phases, each printing its own lines; any failure exits
non-zero:

1. environment: card name and power limit (nvidia-smi), torch/CUDA/nvcc;
2. build the LDPC kernel (both modes) from csrc/ and time the build;
3. the early-stop kernel against its plain torch version on the card, bit
   for bit (hard, soft, crc_ok, iterations), on noisy partly-converging
   codewords from the stored fixture at BG1 z=384 (76 x 4 codeblocks), BG1
   z=208/352 and BG2 z=2/40/104;
4. the fixed-iteration kernel against its plain version, bit for bit (hard,
   soft), on the same kind of input and sizes, where it must differ from the
   early-stop kernel on the rows that converge early and only there;
5. the early-stop slice at the north-star shape (273 PRB, QAM256
   R=948/1024, 4 rx ports, 2 layers, 6 LDPC iterations, batch 4): the
   fixture's JAX-written Tx layer grids mixed by a fixed 4x2 matrix, AWGN
   from a seeded torch.Generator, OFDM-modulated by the port, decoded by
   `build_pusch_rx_slot`; every TB and CB must pass its CRC with the
   fixture's TB bits, and the main path must have launched the kernel;
6. the port's transmitter (`build_ulsch_tx_slot`) on the fixture's TB bits
   at the north-star shape, its layer grids within 1e-3 of the fixture's
   (stored as float16 by the JAX transmitter);
7. the fixed-iteration slice: those port-made grids through the same mix,
   noise and OFDM modulation into `build_pusch_rx_slot` with
   ldpc_early_stop=False; every TB and CB passes, 0 TB bit errors, and the
   call launched the fixed-iteration kernel and never the early-stop one;
8. device-bound timing with CUDA events, one JSON line per metric.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "srsran_projectvtlmo_tpu_torch", "data", "northstar_fixture.npz")
KERNEL_SOURCE = "srsran_projectvtlmo_tpu_torch/csrc/ldpc_decode.cu"
ES_REPLACES = ("srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py:845 (#1), :770 (#2), "
               ":937 (#3)")
FIXED_REPLACES = ("srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py:1026 (#4), :1085 (#5); "
                  "srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas_v2.py:142 (#6)")
#: Bound on |port Tx grid - JAX Tx grid|: the fixture stores the JAX grids as
#: float16, whose half spacing is 2^-11 ~ 4.9e-4 for values in [1, 2).
TX_GRID_TOL = 1e-3


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_call_ms(fn, reps: int, warmup: int = 2) -> list[float]:
    """Device time of each of `reps` calls of fn(), synchronised one by one."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def noisy_llrs(codewords: np.ndarray, count: int, n_filler: int, filler_at: int,
               gen: torch.Generator) -> torch.Tensor:
    """(count, N) int8 LLRs of the codewords (tiled) at a per-row noise level
    from clean to hopeless, so some rows converge early and some never."""
    cw = torch.as_tensor(codewords, device="cuda")[torch.arange(count, device="cuda") % len(codewords)]
    sigma = torch.linspace(0.5, 12.0, count, device="cuda")[:, None]
    noise = torch.randn(cw.shape, generator=gen, device="cuda") * sigma
    llr = torch.clamp(torch.round((1.0 - 2.0 * cw.float()) * 10.0 + noise), -120, 120)
    llr[:, filler_at:filler_at + n_filler] = 127
    return llr.to(torch.int8).contiguous()


def ldpc_cases(fx, gen):
    """Per fixture LDPC case: (case, base graph, z, codeblock count, noisy LLRs);
    76 x 4 codeblocks at the north-star BG1 z=384, 64 elsewhere."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import BaseGraph

    for case in fx["ldpc"]:
        z = case["z"]
        count = 76 * 4 if (case["bg"], z) == (1, 384) else 64
        k = (22 if case["bg"] == 1 else 10) * z
        llr = noisy_llrs(case["codewords"], count, case["filler"], k - 2 * z - case["filler"], gen)
        yield case, BaseGraph(case["bg"]), z, count, llr


def phase_kernel_vs_plain(fx, gen):
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode as plain
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.decode_cuda import ldpc_decode_es_cuda

    max_err = 0
    for case, bg, z, count, llr in ldpc_cases(fx, gen):
        for iters in (2, 6):
            got = ldpc_decode_es_cuda(llr, bg, z, case["crc"], case["kp"], nof_iterations=iters)
            torch.cuda.synchronize()
            ref = plain.ldpc_decode_es(llr, bg, z, case["crc"], case["kp"], nof_iterations=iters)
            names = ("hard", "soft", "crc_ok", "iterations")
            bad = [n for n, a, b in zip(names, got, ref) if not torch.equal(a, b)]
            err = int((got[1].int() - ref[1].int()).abs().max())
            max_err = max(max_err, err)
            print(f"kernel BG{case['bg']} z={z} cbs={count} it={iters}: "
                  f"converged {int(got[2].sum())}/{count}, "
                  f"iterations {np.bincount(got[3].cpu().numpy(), minlength=iters + 1)[1:].tolist()}, "
                  f"max |soft diff| {err}, {'bit-exact' if not bad else 'MISMATCH ' + str(bad)}")
            if bad:
                raise SystemExit(f"kernel disagrees with the plain decoder: {bad}")
    return max_err


def phase_fixed_vs_plain(fx, gen):
    """The fixed-iteration kernel against the plain decoder, bit for bit, on
    rows from clean to hopeless; the early-stop kernel on the same rows gives
    other soft bits exactly where a codeblock converged before the budget."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode as plain
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.decode_cuda import (
        ldpc_decode_cuda, ldpc_decode_es_cuda)

    max_err = 0
    for case, bg, z, count, llr in ldpc_cases(fx, gen):
        for iters in (2, 6):
            hard, soft = ldpc_decode_cuda(llr, bg, z, nof_iterations=iters)
            _, es_soft, es_ok, es_iters = ldpc_decode_es_cuda(llr, bg, z, case["crc"], case["kp"],
                                                              nof_iterations=iters)
            torch.cuda.synchronize()
            ref_hard, ref_soft = plain.ldpc_decode(llr, bg, z, nof_iterations=iters)
            exact = torch.equal(hard, ref_hard) and torch.equal(soft, ref_soft)
            err = int((soft.int() - ref_soft.int()).abs().max())
            max_err = max(max_err, err)
            differs = (soft != es_soft).any(dim=1)
            early = es_ok & (es_iters < iters)
            print(f"fixed kernel BG{case['bg']} z={z} cbs={count} it={iters}: "
                  f"max |soft diff| {err}, {'bit-exact' if exact else 'MISMATCH'}; "
                  f"rows whose soft bits differ from the early-stop kernel "
                  f"{int(differs.sum())}, rows that stopped early {int(early.sum())}")
            if not exact:
                raise SystemExit("fixed-iteration kernel disagrees with the plain decoder")
            if not bool(differs.any()) or bool((differs & ~early).any()):
                raise SystemExit("the fixed and early-stop kernels must differ on the rows "
                                 "that converge early, and only on those")
    return max_err


def northstar_cfg(iterations: int, early_stop: bool = True):
    from srsran_projectvtlmo_tpu_torch.ops.modulation import Modulation
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig

    return PuschRxConfig(nof_rb=273, modulation=Modulation.QAM256,
                         target_code_rate=948.0 / 1024.0, nof_rx_ports=4, nof_layers=2,
                         dft_size=4096, numerology=1, nof_ldpc_iterations=iterations,
                         ldpc_early_stop=early_stop)


def slot_samples(layers, cfg, gen):
    """(B, L, 14, S) complex layer grids -> (B, 4, nsamples, 2): a fixed 4x2
    mix, AWGN from `gen`, the port's OFDM modulator."""
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx

    p = torch.arange(4, device="cuda", dtype=torch.float32)[:, None]
    l = torch.arange(2, device="cuda", dtype=torch.float32)[None, :]
    mix = torch.polar(torch.full((4, 2), 0.5, device="cuda"), -2.0 * np.pi * p * l / 4.0)
    grid = torch.einsum("pl,blsk->bpsk", mix, layers)
    noise = torch.complex(torch.randn(grid.shape, generator=gen, device="cuda"),
                          torch.randn(grid.shape, generator=gen, device="cuda"))
    grid = grid + 0.005 * noise
    return ofdm.ofdm_modulate(from_cplx(grid), cfg.dft_size, cfg.numerology, 0)


def run_slice(cfg, samples, tb_bits, label):
    """Decode `samples` with `build_pusch_rx_slot`; every TB and CB must pass
    with `tb_bits`, and the call must launch the kernel mode of cfg's decoder
    and not the other one.  Returns that mode's launch count."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot, flatten_tb_bits
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode_cuda

    rx = build_pusch_rx_slot(cfg, "cuda")
    rx(samples)  # first call builds tables and warms up
    torch.cuda.synchronize()

    decode_cuda.reset_launch_counts()
    out = rx(samples)
    torch.cuda.synchronize()
    launches = dict(decode_cuda.LAUNCHES)

    b = samples.shape[0]
    seg = cfg.segmentation
    expect = {"tb_crc_ok": (b,), "cb_crc_ok": (b, seg.nof_cb),
              "ldpc_iterations": (b, seg.nof_cb),
              "harq_soft": (b, seg.nof_cb, seg.nof_cw_bits_per_cb),
              "snr_db": (b,), "evm": (b,), "ta_s": (b,)}
    for key, shape in expect.items():
        if tuple(out[key].shape) != shape:
            raise SystemExit(f"{key} has shape {tuple(out[key].shape)}, expected {shape}")
    for key in ("snr_db", "evm", "ta_s"):
        if not bool(torch.isfinite(out[key]).all()):
            raise SystemExit(f"{key} is not finite: {out[key].tolist()}")
    tb = flatten_tb_bits(out["tb_bits_cb"].cpu().numpy(), cfg.tbs)
    bit_errors = int((tb != tb_bits).sum())
    mode, other = (("ldpc_decode_es", "ldpc_decode") if cfg.ldpc_early_stop
                   else ("ldpc_decode", "ldpc_decode_es"))
    print(f"{label} 273 PRB QAM256 4x2, batch {b}: tb_crc_ok {out['tb_crc_ok'].tolist()}, "
          f"cb_crc_ok {int(out['cb_crc_ok'].sum())}/{out['cb_crc_ok'].numel()}, "
          f"TB bit errors {bit_errors}, iterations max {int(out['ldpc_iterations'].max())}, "
          f"snr_db {[round(v, 2) for v in out['snr_db'].tolist()]}, "
          f"evm {[round(v, 4) for v in out['evm'].tolist()]}, kernel launches {launches}")
    if not (bool(out["tb_crc_ok"].all()) and bool(out["cb_crc_ok"].all()) and bit_errors == 0):
        raise SystemExit(f"{label}: the north-star slot did not decode to the fixture's TB bits")
    if launches[mode] == 0 or launches[other] != 0:
        raise SystemExit(f"{label}: the main path must launch {mode} and not {other}: {launches}")
    return launches[mode]


def phase_slice(fx, gen):
    """The early-stop slice on the fixture's JAX-written Tx grids."""
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    cfg = northstar_cfg(6)
    if cfg.tbs != fx["cfg"]["tbs"]:
        raise SystemExit(f"fixture TBS {fx['cfg']['tbs']} != config TBS {cfg.tbs}")
    layers = to_cplx(torch.as_tensor(fx["layer_grids"], device="cuda"))  # (B, L, 14, S)
    return run_slice(cfg, slot_samples(layers, cfg, gen), fx["tb_bits"], "early-stop slice")


def phase_tx(fx):
    """The port's transmitter on the fixture's TB bits against the JAX
    transmitter's layer grids; returns the port's grids (B, L, 14, S) complex."""
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    cfg = northstar_cfg(6)
    tb = torch.as_tensor(fx["tb_bits"], device="cuda")
    tx = build_ulsch_tx_slot(cfg, "cuda")
    calls = cuda_call_ms(lambda: tx(tb), reps=3, warmup=1)
    grid, samples = tx(tb)
    torch.cuda.synchronize()
    ref = torch.as_tensor(fx["layer_grids"], device="cuda")
    err = float((grid - ref).abs().max()) if grid.shape == ref.shape else float("inf")
    nsamp = samples.shape[-2]
    print(f"port Tx 273 PRB QAM256 2 layers, batch {tb.shape[0]}: grid {tuple(grid.shape)}, "
          f"max |grid - JAX grid| {err:.3g} (bound {TX_GRID_TOL}), samples {nsamp} per layer, "
          f"{float(np.median(calls)):.2f} ms per call (CUDA events, median of {len(calls)})")
    if not err <= TX_GRID_TOL:
        raise SystemExit("the port's Tx grids differ from the JAX-written fixture")
    if not bool(torch.isfinite(samples).all()):
        raise SystemExit("the port's Tx samples are not finite")
    return to_cplx(grid)


def phase_fixed_slice(layers, fx, gen):
    """The fixed-iteration slice on the port's own Tx grids."""
    cfg = northstar_cfg(6, early_stop=False)
    return run_slice(cfg, slot_samples(layers, cfg, gen), fx["tb_bits"], "fixed-iteration slice")


def metric_line(metric, value, unit, **extra):
    print(json.dumps({"metric": metric, "value": value, "unit": unit, "platform": "gpu",
                      "device": torch.cuda.get_device_name(0), **extra}))


def bench_ldpc_llrs(count: int, gen):
    """bench.py's LDPC input: random BG1 z=384 info bits (count, K) encoded by
    the port's encoder, as LLRs +/-8 (count, N) int8.  Returns (info, llr,
    encoder ms per call)."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.encode import ldpc_encode
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import BaseGraph, get_graph

    z = 384
    info = torch.randint(0, 2, (count, get_graph(BaseGraph.BG1, z).k), generator=gen,
                         device="cuda", dtype=torch.uint8)
    enc_ms = cuda_time_ms(lambda: ldpc_encode(info, BaseGraph.BG1, z), reps=5, warmup=1)
    cw = ldpc_encode(info, BaseGraph.BG1, z)[:, 2 * z:]
    llr = ((1 - 2 * cw.to(torch.int32)) * 8).to(torch.int8).contiguous()
    return info, llr, enc_ms


def phase_timing(gen):
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import BaseGraph
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode as plain
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.decode_cuda import (
        ldpc_decode_cuda, ldpc_decode_es_cuda)

    # Random-RE slots never pass CRC: the decoder runs its full budget, as in
    # bench.py's device-bound cells.
    cfg = northstar_cfg(2)
    rx = build_pusch_rx_slot(cfg, "cuda")
    nsamp = ofdm.slot_sample_count(cfg.dft_size, cfg.numerology, 0)
    x32 = torch.randn((32, 4, nsamp, 2), generator=gen, device="cuda") * 0.3
    ms = cuda_time_ms(lambda: rx(x32), reps=5)
    metric_line("pusch_rx_device_bound_slot_rate_273prb_qam256_4port_2layer",
                32 / (ms / 1e3), "slots/s (CUDA events, batch 32, 2 LDPC iterations)",
                ms_per_launch=ms, vs_baseline=32 / (ms / 1e3) / 2000.0)
    for b in (1, 4):
        xb = x32[:b].contiguous()
        calls = cuda_call_ms(lambda: rx(xb), reps=20)
        ms = float(np.median(calls))
        metric_line(f"pusch_rx_device_latency_batch{b}", ms,
                    f"ms (CUDA events, median of {len(calls)} synchronised calls, "
                    f"{b} slot{'s' if b > 1 else ''}, 2 LDPC iterations)",
                    min_ms=min(calls), max_ms=max(calls), vs_baseline=b * 0.5 / ms)
    for early_stop, suffix in ((True, "full"), (False, "fixed")):
        rx6 = build_pusch_rx_slot(northstar_cfg(6, early_stop), "cuda")
        ms = cuda_time_ms(lambda: rx6(x32), reps=3)
        metric_line(f"pusch_rx_device_bound_slot_rate_4port_2layer_6it_{suffix}",
                    32 / (ms / 1e3), f"slots/s (CUDA events, batch 32 random-RE slots, "
                    f"6 LDPC iterations, {'early-stop' if early_stop else 'fixed-iteration'} "
                    f"decoder, full budget)", ms_per_launch=ms)
    del x32, xb

    g = plain.get_graph(BaseGraph.BG1, 384)
    cbs = 76 * 4
    llr = torch.randint(-120, 121, (cbs, g.n), generator=gen, device="cuda",
                        dtype=torch.int8)
    es_ms = cuda_time_ms(lambda: ldpc_decode_es_cuda(llr, BaseGraph.BG1, 384, "CRC24B", g.k,
                                                     nof_iterations=2), reps=20)
    es_plain_ms = cuda_time_ms(lambda: plain.ldpc_decode_es(llr, BaseGraph.BG1, 384, "CRC24B",
                                                            g.k, nof_iterations=2),
                               reps=5, warmup=1)
    metric_line("ldpc_decode_es_bg1_z384_2it", cbs * g.k / (es_ms / 1e3) / 1e6,
                f"Mbps (CUDA events, {cbs} codeblocks of random LLRs, early-stop kernel, "
                f"never converging)", kernel_ms=es_ms, plain_ms=es_plain_ms,
                plain_mbps=cbs * g.k / (es_plain_ms / 1e3) / 1e6)

    # bench.py's definition: 608 encoded codeblocks, fixed iterations, hard bits checked.
    cbs = 608
    info, llr, enc_ms = bench_ldpc_llrs(cbs, gen)
    metric_line("ldpc_encode_bg1_z384", enc_ms,
                f"ms per call (CUDA events, {cbs} codeblocks, plain torch encoder)")
    hard, _ = ldpc_decode_cuda(llr, BaseGraph.BG1, 384, nof_iterations=2)
    torch.cuda.synchronize()
    if not torch.equal(hard, info):
        raise SystemExit("fixed-iteration kernel: hard bits != encoded info bits")
    fx_ms = cuda_time_ms(lambda: ldpc_decode_cuda(llr, BaseGraph.BG1, 384, nof_iterations=2),
                         reps=20)
    fx_plain_ms = cuda_time_ms(lambda: plain.ldpc_decode(llr, BaseGraph.BG1, 384,
                                                         nof_iterations=2), reps=3, warmup=1)
    metric_line("ldpc_decode_bg1_z384_2it", cbs * g.k / (fx_ms / 1e3) / 1e6,
                f"Mbps (CUDA events, {cbs} codeblocks of random info encoded by the port, "
                f"LLRs +/-8, fixed-iteration kernel, hard bits == info)",
                kernel_ms=fx_ms, plain_ms=fx_plain_ms,
                plain_mbps=cbs * g.k / (fx_plain_ms / 1e3) / 1e6)
    return {"ldpc_decode_es": (es_ms, es_plain_ms), "ldpc_decode": (fx_ms, fx_plain_ms)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from srsran_projectvtlmo_tpu_torch.fixture import load_fixture
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([decode_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = decode_cuda.build(verbose=True)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    fx = load_fixture(FIXTURE)
    es_err = phase_kernel_vs_plain(fx, gen)
    es_launches = phase_slice(fx, gen)
    fx_err = phase_fixed_vs_plain(fx, gen)
    layers = phase_tx(fx)
    fx_launches = phase_fixed_slice(layers, fx, gen)
    times = phase_timing(gen)

    rows = [("ldpc_decode_es", ES_REPLACES, es_launches, es_err),
            ("ldpc_decode", FIXED_REPLACES, fx_launches, fx_err)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times[name][0],
        "plain_ms": times[name][1]} for name, replaces, launches, err in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
