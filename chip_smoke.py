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
4b. both modes against the plain decoders, bit for bit, at all 51 lifting
   sizes of BG1 and BG2, 2 and 6 iterations, on 12 CRC-terminated codeblocks
   per size (encoded by the port, filler at +127) from clean to hopeless;
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
8. device-bound timing with CUDA events, one JSON line per metric, each
   kernel line with its bound (see `ldpc_bound`);
9. a torch.profiler breakdown of the north-star slot at batch 32: device
   kernel time per call and the LDPC kernel's share, 2 and 6 iterations;
10. the UCI slice at the north-star shape, batch 4: the port's Tx sends a
   2-bit HARQ-ACK (short block, punctures the SCH), a 20-bit CSI part 1 and
   a 48-bit CSI part 2 (CRC11 + polar) through the same mix, noise and OFDM
   into `build_pusch_rx_slot`; every TB, CB, ACK and CSI bit must come back,
   CSI metrics 1.0, with the early-stop kernel launched; then a batch with
   a 40-bit ACK (polar, rate-matched around the SCH);
11. the CSI part-1 -> part-2 protocol: `PuschUciProcessor` with a 6-bit CSI
   part 1 and a 64-entry part-2 size map, one batch whose part 1 selects a
   24-bit (polar) part 2 and one that selects none; phase B launches the
   kernel; one two-phase call timed;
12. receiver options, each decoding every TB with the kernel launched:
   ZF and DM-RS type 2 at 4x2; `dynamic_params` with four UEs (distinct
   rnti and n_id) in one batch-4 call, SCH only and with the UCI fields of
   phase 10 (per-row DM-RS references, descrambling and placeholder fix
   signs built on the host); intra-slot hopping at 1 layer x 4 ports, a
   136-PRB allocation whose second hop starts at PRB 137 of the 273-PRB
   carrier, each hop's rows gathered from the demodulated carrier;
13. a torch.profiler profile of the UCI slice at batch 32 (random REs, 6
   iterations, early stop): device time and kernel launches per call, the
   time and launches inside `pusch_rx.uci`, the launches of each UCI
   field's decoder, and the back-to-back time per call.

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
#: The LDPC bound's convention: about ten integer operations per edge and
#: check lane per sweep (layered min-sum: subtract, absolute value, three for
#: min1/min2/argmin, one sign bit; then pick the magnitude, apply the sign,
#: add, saturate), on 16-bit lanes: no value needs more than 10 bits
#: (|v2c| <= 362), and Hopper's integer add/min/max (VIADD, VIMNMX,
#: VIADDMNMX) work on two 16-bit halves of a register at the int32 issue
#: rate, so the H100 SXM does 132 SMs x 64 lanes x 2 halves per clock x
#: 1.98 GHz; bytes at 3.35 TB/s, each input read once and each output written
#: once.
LDPC_OPS_PER_EDGE_LANE = 10
PACKED16_OPS_PER_S = 132 * 64 * 2 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
#: Bound on |port Tx grid - JAX Tx grid|: the fixture stores the JAX grids as
#: float16, whose half spacing is 2^-11 ~ 4.9e-4 for values in [1, 2).
TX_GRID_TOL = 1e-3
#: The north-star carrier, and the hopping phase's allocation in it: 136 PRB
#: from PRB 0, the second hop from PRB 137 (the carrier's last 136 PRB).
NS_PRB, NS_DFT = 273, 4096
HOP_PRB, SECOND_HOP_PRB = 136, 137
#: Four UEs of one dynamic_params call: (rnti, n_id).
UES = ((0x4601, 1), (0x1234, 77), (0x2B67, 500), (0x7001, 1007))
#: Two-phase CSI: part-2 size by the value of the 6-bit part 1.
PART2_MAP = tuple((0, 24, 8, 64)[v % 4] for v in range(64))
UCI_FIELDS = dict(nof_harq_ack_bits=2, nof_csi_part1_bits=20, nof_csi_part2_bits=48)


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


def sweep_cases(gen, count: int = 12):
    """All 51 lifting sizes of both base graphs: (bg, z, crc, kp, noisy LLRs
    of `count` CRC-terminated random codeblocks encoded by the port, filler
    at +127, from clean to hopeless, the last row uniform over all of int8)."""
    from srsran_projectvtlmo_tpu_torch.ops.crc import crc_device
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.encode import ldpc_encode
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import BaseGraph, get_graph
    from srsran_projectvtlmo_tpu_torch.ran.ldpc_params import ALL_LIFTING_SIZES

    for bg in (BaseGraph.BG1, BaseGraph.BG2):
        for z in ALL_LIFTING_SIZES:
            k = get_graph(bg, z).k
            crc = "CRC24B" if k > 48 else "CRC16"
            filler = min(k // 8, 64)
            kp = k - filler
            payload = torch.randint(0, 2, (count, kp - (24 if crc == "CRC24B" else 16)),
                                    generator=gen, device="cuda", dtype=torch.uint8)
            info = torch.cat([payload, crc_device(payload, crc),
                              torch.zeros((count, filler), dtype=torch.uint8, device="cuda")], 1)
            cw = ldpc_encode(info, bg, z)[:, 2 * z:]
            llr = noisy_llrs(cw, count, filler, kp - 2 * z, gen)
            llr[-1] = torch.randint(-128, 128, llr[-1].shape, generator=gen, device="cuda",
                                    dtype=torch.int8)  # never converges; holds -128 too
            yield bg, z, crc, kp, llr


def phase_all_sizes(gen):
    """Both kernel modes against the plain decoders at every lifting size."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode as plain
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.decode_cuda import (
        ldpc_decode_cuda, ldpc_decode_es_cuda)

    max_err, checked = 0, 0
    for bg, z, crc, kp, llr in sweep_cases(gen):
        conv = []
        for iters in (2, 6):
            es = ldpc_decode_es_cuda(llr, bg, z, crc, kp, nof_iterations=iters)
            fixed = ldpc_decode_cuda(llr, bg, z, nof_iterations=iters)
            torch.cuda.synchronize()
            es_ref = plain.ldpc_decode_es(llr, bg, z, crc, kp, nof_iterations=iters)
            fixed_ref = plain.ldpc_decode(llr, bg, z, nof_iterations=iters)
            names = ("hard", "soft", "crc_ok", "iterations")
            bad = [f"es {n}" for n, a, b in zip(names, es, es_ref) if not torch.equal(a, b)]
            bad += [f"fixed {n}" for n, a, b in zip(("hard", "soft"), fixed, fixed_ref)
                    if not torch.equal(a, b)]
            for got, ref in ((es[1], es_ref[1]), (fixed[1], fixed_ref[1])):
                max_err = max(max_err, int((got.int() - ref.int()).abs().max()))
            if bad:
                raise SystemExit(f"all-sizes sweep BG{int(bg)} z={z} it={iters}: kernel "
                                 f"disagrees with the plain decoder: {bad}")
            conv.append(f"it={iters} converged {int(es[2].sum())}/{llr.shape[0]}")
            checked += 1
        print(f"sweep BG{int(bg)} z={z} {crc} kp={kp}: {', '.join(conv)}; both modes bit-exact")
    print(f"all-sizes sweep: {checked} (graph, iterations) cases x 2 modes bit-exact, "
          f"max |soft diff| {max_err}")
    return max_err


def ldpc_bound(bg, z: int, cbs: int, sweeps: int, early_stop: bool):
    """(bound ms, what bounds it) for decoding `cbs` codeblocks in `sweeps`
    sweeps in all (counted from the run's own iterations)."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import get_graph

    g = get_graph(bg, z)
    ops = LDPC_OPS_PER_EDGE_LANE * int((g.shifts >= 0).sum()) * z * sweeps
    nbytes = cbs * (g.n + 2 * g.k) + ((cbs * 5 + 4 * g.k) if early_stop else 0)
    t_ops, t_bytes = ops / PACKED16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def northstar_cfg(iterations: int, early_stop: bool = True, **kw):
    from srsran_projectvtlmo_tpu_torch.ops.modulation import Modulation
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig

    return PuschRxConfig(**{"nof_rb": NS_PRB, "modulation": Modulation.QAM256,
                            "target_code_rate": 948.0 / 1024.0, "nof_rx_ports": 4,
                            "nof_layers": 2, "dft_size": NS_DFT, "numerology": 1,
                            "nof_ldpc_iterations": iterations, "ldpc_early_stop": early_stop,
                            **kw})


def slot_samples(layers, cfg, gen):
    """(B, L, 14, S) complex layer grids -> (B, 4, nsamples, 2): a fixed 4xL
    mix, AWGN from `gen`, the port's OFDM modulator."""
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx

    nl = layers.shape[1]
    p = torch.arange(4, device="cuda", dtype=torch.float32)[:, None]
    l = torch.arange(nl, device="cuda", dtype=torch.float32)[None, :]
    mix = torch.polar(torch.full((4, nl), 0.5, device="cuda"), -2.0 * np.pi * p * l / 4.0)
    grid = torch.einsum("pl,blsk->bpsk", mix, layers)
    noise = torch.complex(torch.randn(grid.shape, generator=gen, device="cuda"),
                          torch.randn(grid.shape, generator=gen, device="cuda"))
    grid = grid + 0.005 * noise
    return ofdm.ofdm_modulate(from_cplx(grid), cfg.dft_size, cfg.numerology, 0)


def count_launches(fn, early_stop: bool, label: str):
    """fn() with the kernel launch counts set to 0 just before and read just
    after: the call must launch the mode of the decoder it was configured
    with and not the other one.  Returns (fn's result, that mode's count)."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode_cuda

    mode, other = (("ldpc_decode_es", "ldpc_decode") if early_stop
                   else ("ldpc_decode", "ldpc_decode_es"))
    decode_cuda.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(decode_cuda.LAUNCHES)
    if launches[mode] == 0 or launches[other] != 0:
        raise SystemExit(f"{label}: the path must launch {mode} and not {other}: {launches}")
    return out, launches[mode]


def run_slice(cfg, samples, tb_bits, label):
    """Decode `samples` with `build_pusch_rx_slot`; every TB and CB must pass
    with `tb_bits`, and the call must launch the kernel mode of cfg's decoder
    and not the other one.  Returns that mode's launch count."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot, flatten_tb_bits

    rx = build_pusch_rx_slot(cfg, "cuda")
    rx(samples)  # first call builds tables and warms up
    torch.cuda.synchronize()
    out, count = count_launches(lambda: rx(samples), cfg.ldpc_early_stop, label)

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
    print(f"{label} {cfg.nof_rb} PRB QAM256 4x{cfg.nof_layers}, batch {b}: "
          f"tb_crc_ok {out['tb_crc_ok'].tolist()}, "
          f"cb_crc_ok {int(out['cb_crc_ok'].sum())}/{out['cb_crc_ok'].numel()}, "
          f"TB bit errors {bit_errors}, iterations max {int(out['ldpc_iterations'].max())}, "
          f"snr_db {[round(v, 2) for v in out['snr_db'].tolist()]}, "
          f"evm {[round(v, 4) for v in out['evm'].tolist()]}, kernel launches {count}")
    if not (bool(out["tb_crc_ok"].all()) and bool(out["cb_crc_ok"].all()) and bit_errors == 0):
        raise SystemExit(f"{label}: the north-star slot did not decode to the fixture's TB bits")
    return count


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
    es_sweeps = int(ldpc_decode_es_cuda(llr, BaseGraph.BG1, 384, "CRC24B", g.k,
                                        nof_iterations=2)[3].sum())
    es_bound = ldpc_bound(BaseGraph.BG1, 384, cbs, es_sweeps, True)
    es_ms = cuda_time_ms(lambda: ldpc_decode_es_cuda(llr, BaseGraph.BG1, 384, "CRC24B", g.k,
                                                     nof_iterations=2), reps=20)
    es_plain_ms = cuda_time_ms(lambda: plain.ldpc_decode_es(llr, BaseGraph.BG1, 384, "CRC24B",
                                                            g.k, nof_iterations=2),
                               reps=5, warmup=1)
    metric_line("ldpc_decode_es_bg1_z384_2it", cbs * g.k / (es_ms / 1e3) / 1e6,
                f"Mbps (CUDA events, {cbs} codeblocks of random LLRs, early-stop kernel, "
                f"never converging)", kernel_ms=es_ms, plain_ms=es_plain_ms,
                plain_mbps=cbs * g.k / (es_plain_ms / 1e3) / 1e6, bound_ms=es_bound[0],
                share_of_bound=es_bound[0] / es_ms)

    # bench.py's definition: 608 encoded codeblocks, fixed iterations, hard bits checked.
    cbs = 608
    info, llr, enc_ms = bench_ldpc_llrs(cbs, gen)
    metric_line("ldpc_encode_bg1_z384", enc_ms,
                f"ms per call (CUDA events, {cbs} codeblocks, plain torch encoder)")
    hard, _ = ldpc_decode_cuda(llr, BaseGraph.BG1, 384, nof_iterations=2)
    torch.cuda.synchronize()
    if not torch.equal(hard, info):
        raise SystemExit("fixed-iteration kernel: hard bits != encoded info bits")
    fx_bound = ldpc_bound(BaseGraph.BG1, 384, cbs, 2 * cbs, False)
    fx_ms = cuda_time_ms(lambda: ldpc_decode_cuda(llr, BaseGraph.BG1, 384, nof_iterations=2),
                         reps=20)
    fx_plain_ms = cuda_time_ms(lambda: plain.ldpc_decode(llr, BaseGraph.BG1, 384,
                                                         nof_iterations=2), reps=3, warmup=1)
    metric_line("ldpc_decode_bg1_z384_2it", cbs * g.k / (fx_ms / 1e3) / 1e6,
                f"Mbps (CUDA events, {cbs} codeblocks of random info encoded by the port, "
                f"LLRs +/-8, fixed-iteration kernel, hard bits == info)",
                kernel_ms=fx_ms, plain_ms=fx_plain_ms,
                plain_mbps=cbs * g.k / (fx_plain_ms / 1e3) / 1e6, bound_ms=fx_bound[0],
                share_of_bound=fx_bound[0] / fx_ms)
    return {"ldpc_decode_es": (es_ms, es_plain_ms, *es_bound),
            "ldpc_decode": (fx_ms, fx_plain_ms, *fx_bound)}


def phase_profile(gen):
    """torch.profiler over 3 calls of the north-star slot at batch 32 (random
    REs, full LDPC budget): device kernel time per call and the LDPC kernel's
    part, annotation spans excluded.  A profiler that records no device
    events prints "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot
    from srsran_projectvtlmo_tpu_torch.ops import ofdm

    calls = 3
    for iters, early_stop in ((2, True), (6, True), (6, False)):
        cfg = northstar_cfg(iters, early_stop)
        rx = build_pusch_rx_slot(cfg, "cuda")
        nsamp = ofdm.slot_sample_count(cfg.dft_size, cfg.numerology, 0)
        x = torch.randn((32, 4, nsamp, 2), generator=gen, device="cuda") * 0.3
        rx(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                rx(x)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / calls
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("pusch_rx.")]
        total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
        ldpc = sum(e.time_range.elapsed_us() for e in kernels
                   if "ldpc_decode_kernel" in e.name) / 1e3 / calls
        mode = "early-stop" if early_stop else "fixed"
        if not kernels:
            print(f"profile batch 32, {iters} iterations, {mode}: not measured "
                  f"(no device events)")
            continue
        print(json.dumps({"profile": f"pusch_rx_batch32_{iters}it_{mode}",
                          "device_kernel_ms_per_call": total, "ldpc_kernel_ms_per_call": ldpc,
                          "ldpc_share": ldpc / total,
                          "kernels_per_call": len(kernels) / calls,
                          "host_ms_per_call_under_profiler": host_ms,
                          "device": torch.cuda.get_device_name(0)}))
        del x


def uci_payloads(cfg, batch: int, gen, csi2: int | None = None) -> dict:
    """Random (batch, K) payload bits on the card for each UCI field of cfg."""
    sizes = {"ack_bits": cfg.nof_harq_ack_bits, "csi1_bits": cfg.nof_csi_part1_bits,
             "csi2_bits": cfg.nof_csi_part2_bits if csi2 is None else csi2}
    return {k: torch.randint(0, 2, (batch, n), generator=gen, device="cuda", dtype=torch.uint8)
            for k, n in sizes.items() if n}


def random_tb(cfg, batch: int, gen) -> torch.Tensor:
    return torch.randint(0, 2, (batch, cfg.tbs), generator=gen, device="cuda", dtype=torch.uint8)


def check_decoded(out, cfg, tb, uci, label: str, launches: int) -> None:
    """Every TB and CB passes with the sent TB bits; every UCI bit equals what
    was sent; a polar field's metric (its CRC verdict) is 1.0 and a short-block
    field's detection metric clears 0.25, the decoder's validity threshold."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import flatten_tb_bits

    tb_rx = flatten_tb_bits(out["tb_bits_cb"].cpu().numpy(), cfg.tbs)
    bit_errors = int((tb_rx != tb.cpu().numpy()).sum())
    ok = bool(out["tb_crc_ok"].all()) and bool(out["cb_crc_ok"].all()) and bit_errors == 0
    fields = []
    for name, sent in uci.items():
        key = "harq_ack" if name == "ack_bits" else name[:-len("_bits")]
        errors = int((torch.as_tensor(out[f"{key}_bits"], device=sent.device) != sent).sum())
        metric = torch.as_tensor(out[f"{key}_metric"]).float()
        good = bool((metric == 1.0).all()) if sent.shape[1] >= 12 else bool((metric > 0.25).all())
        ok = ok and errors == 0 and good
        fields.append(f"{key} {sent.shape[1]} bits: errors {errors}, "
                      f"metric {[round(v, 4) for v in metric.tolist()]}")
    for key in ("snr_db", "evm", "ta_s"):
        ok = ok and bool(torch.isfinite(out[key]).all())
    print(f"{label} {cfg.nof_rb} PRB QAM256 {cfg.nof_rx_ports}x{cfg.nof_layers}, batch "
          f"{tb.shape[0]}: tb_crc_ok {out['tb_crc_ok'].tolist()}, cb_crc_ok "
          f"{int(out['cb_crc_ok'].sum())}/{out['cb_crc_ok'].numel()}, TB bit errors {bit_errors}; "
          f"{'; '.join(fields) or 'no UCI'}; kernel launches {launches}")
    if not ok:
        raise SystemExit(f"{label}: the slot did not decode to what was sent")


def uci_slice(cfg, batch: int, gen, label: str) -> int:
    """The port's Tx with cfg's UCI fields -> mix, noise, OFDM -> the receive
    slot; checked as `check_decoded`.  Returns the launches of the call."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    tb, uci = random_tb(cfg, batch, gen), uci_payloads(cfg, batch, gen)
    grid, _ = build_ulsch_tx_slot(cfg, "cuda")(tb, **uci)
    samples = slot_samples(to_cplx(grid), cfg, gen)
    rx = build_pusch_rx_slot(cfg, "cuda")
    rx(samples)
    torch.cuda.synchronize()
    out, launches = count_launches(lambda: rx(samples), True, label)
    check_decoded(out, cfg, tb, uci, label, launches)
    return launches


def phase_uci(gen) -> dict:
    """The UCI slice (2-bit ACK, 20-bit CSI part 1, 48-bit CSI part 2) and a
    40-bit ACK, each at batch 4."""
    return {"uci": uci_slice(northstar_cfg(6, **UCI_FIELDS), 4, gen, "UCI slice"),
            "ack40": uci_slice(northstar_cfg(6, nof_harq_ack_bits=40), 4, gen,
                               "large-ACK slice")}


def demodulate(samples, cfg):
    from srsran_projectvtlmo_tpu_torch.ops import ofdm

    return ofdm.ofdm_demodulate(samples, cfg.nof_subc, cfg.dft_size, cfg.numerology, 0,
                                out_dtype="bf16")


def phase_two_phase(gen) -> dict:
    """`PuschUciProcessor` (phase A with decode_sch=False, the part-2 size
    decided on the host from the decoded part 1, phase B) on a batch whose
    part 1 selects a 24-bit polar part 2 and on one that selects none."""
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.phy.pusch_uci import PuschUciConfig, PuschUciProcessor
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    cfg = northstar_cfg(6, nof_harq_ack_bits=2, nof_csi_part1_bits=6)
    proc = PuschUciProcessor(PuschUciConfig(rx=cfg, part2_size_map=PART2_MAP), "cuda")
    launches = {}
    for value in (5, 4):
        size = PART2_MAP[value]
        tb, uci = random_tb(cfg, 4, gen), uci_payloads(cfg, 4, gen, csi2=size)
        uci["csi1_bits"][:] = torch.tensor([(value >> (5 - i)) & 1 for i in range(6)],
                                           dtype=torch.uint8, device="cuda")
        grid, _ = build_ulsch_tx_slot(cfg, "cuda", nof_csi_part2_bits=size)(tb, **uci)
        rx_grid = demodulate(slot_samples(to_cplx(grid), cfg, gen), cfg)
        proc.process(rx_grid)
        torch.cuda.synchronize()
        label = f"two-phase CSI, part 1 = {value} -> part 2 of {size} bits"
        out, n = count_launches(lambda: proc.process(rx_grid), True, label)
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            proc.process(rx_grid)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        if out["csi2_size"] != size or not bool(np.all(out["csi1_valid"])):
            raise SystemExit(f"{label}: part 2 sized {out['csi2_size']}, part 1 valid "
                             f"{out['csi1_valid']}")
        check_decoded(out, cfg, tb, uci, label, n)
        print(json.dumps({"profile": f"pusch_uci_two_phase_batch4_csi2_{size}",
                          "host_ms_per_call": float(np.median(host_ms)),
                          "host_ms_calls": host_ms, "kernel_launches": n,
                          "device": torch.cuda.get_device_name(0)}))
        launches[f"two_phase_csi2_{size}"] = n
    return launches


def dynamic_inputs(rx_cfg, ue_cfgs):
    """Per-row call inputs of a dynamic_params receiver, built on the host:
    DM-RS references, descrambling signs from cinit = (rnti << 15) + n_id and
    the UCI placeholder fix signs, all on the card."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import cached_demux_plan, dmrs_reference
    from srsran_projectvtlmo_tpu_torch.ops import prg
    from srsran_projectvtlmo_tpu_torch.ops.ulsch_demux import placeholder_fix_signs
    from srsran_projectvtlmo_tpu_torch.ran.modulation import bits_per_symbol
    from srsran_projectvtlmo_tpu_torch.utils.cplx import np_to_pair

    qm = bits_per_symbol(rx_cfg.modulation)
    plan, _ = cached_demux_plan(rx_cfg)
    refs, signs, fixes = [], [], {"ack": [], "csi1": [], "csi2": []}
    for ue in ue_cfgs:
        refs.append(np_to_pair(dmrs_reference(ue)))
        scr = prg.gold_sequence_bits(ue.scrambling_cinit(), rx_cfg.nof_codeword_bits)
        signs.append(1 - 2 * scr.astype(np.int8))
        for name, payload in (("ack", rx_cfg.nof_harq_ack_bits),
                              ("csi1", rx_cfg.nof_csi_part1_bits),
                              ("csi2", rx_cfg.nof_csi_part2_bits)):
            if payload:
                fixes[name].append(placeholder_fix_signs(plan.field_bit_idx(name), payload, qm,
                                                         scr).astype(np.int8))
    on_card = lambda rows: torch.as_tensor(np.stack(rows), device="cuda")
    return (on_card(refs), on_card(signs),
            tuple(on_card(fixes[n]) if fixes[n] else None for n in ("ack", "csi1", "csi2")))


def phase_options(fx, gen) -> dict:
    """ZF and DM-RS type 2 at 4x2; dynamic_params with four UEs in one call,
    SCH only and with UCI; intra-slot hopping at 1 layer x 4 ports."""
    import dataclasses

    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import (
        PuschRxConfig, build_pusch_rx_from_grid)
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.ops.modulation import Modulation
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    launches = {}
    cfg = northstar_cfg(6, equalizer="zf")
    layers = to_cplx(torch.as_tensor(fx["layer_grids"], device="cuda"))
    launches["zf"] = run_slice(cfg, slot_samples(layers, cfg, gen), fx["tb_bits"], "ZF slice")
    del layers
    cfg = northstar_cfg(6, dmrs_config_type=2)
    grid, _ = build_ulsch_tx_slot(cfg, "cuda")(torch.as_tensor(fx["tb_bits"], device="cuda"))
    launches["dmrs_type2"] = run_slice(cfg, slot_samples(to_cplx(grid), cfg, gen),
                                       fx["tb_bits"], "DM-RS type 2 slice")

    for name, kw in (("dynamic_sch", {}), ("dynamic_uci", UCI_FIELDS)):
        cfg = northstar_cfg(6, dynamic_params=True, **kw)
        ues = [dataclasses.replace(cfg, dynamic_params=False, rnti=r, n_id=n) for r, n in UES]
        tb, uci = random_tb(cfg, len(ues), gen), uci_payloads(cfg, len(ues), gen)
        grids = [build_ulsch_tx_slot(ue, "cuda")(tb[i:i + 1], **{k: v[i:i + 1]
                                                                  for k, v in uci.items()})[0]
                 for i, ue in enumerate(ues)]
        rx_grid = demodulate(slot_samples(to_cplx(torch.cat(grids)), cfg, gen), cfg)
        del grids
        ref, signs, fix = dynamic_inputs(cfg, ues)
        rx = build_pusch_rx_from_grid(cfg, "cuda")
        call = lambda: rx(rx_grid, None, ref, signs, fix if uci else None)
        call()
        torch.cuda.synchronize()
        label = f"dynamic_params, {len(ues)} UEs (rnti, n_id) {list(UES)}, " + \
            ("with UCI" if uci else "SCH only")
        out, launches[name] = count_launches(call, True, label)
        check_decoded(out, cfg, tb, uci, label, launches[name])

    cfg = PuschRxConfig(nof_rb=HOP_PRB, modulation=Modulation.QAM256,
                        target_code_rate=948.0 / 1024.0, nof_rx_ports=4, nof_layers=1,
                        dft_size=NS_DFT, numerology=1, dmrs_symbols=(2, 9), hop_symbol=7,
                        second_hop_prb=SECOND_HOP_PRB, nof_ldpc_iterations=6)
    tb = random_tb(cfg, 4, gen)
    grid = to_cplx(build_ulsch_tx_slot(cfg, "cuda")(tb)[0])  # (B, 14, S) allocation
    # Each symbol's rows sit at its hop's PRB in the carrier; the receiver
    # takes the rows gathered back from the demodulated carrier.
    hop_start = torch.tensor([(SECOND_HOP_PRB if s >= cfg.hop_symbol else cfg.rb_start) * 12
                              for s in range(14)], device="cuda")
    rows = hop_start[:, None] + torch.arange(cfg.nof_subc, device="cuda")[None, :]
    sym = torch.arange(14, device="cuda")[:, None]
    carrier = torch.zeros((grid.shape[0], 14, NS_PRB * 12), dtype=grid.dtype, device="cuda")
    carrier[:, sym, rows] = grid
    car_cfg = northstar_cfg(6, nof_layers=1)
    rx_carrier = demodulate(slot_samples(carrier[:, None], car_cfg, gen), car_cfg)
    rx_grid = rx_carrier[:, :, sym, rows]  # (B, 4, 14, S, 2)
    rx = build_pusch_rx_from_grid(cfg, "cuda")
    rx(rx_grid)
    torch.cuda.synchronize()
    label = (f"hopping, PRB {cfg.rb_start} then {SECOND_HOP_PRB} of {NS_PRB} from symbol "
             f"{cfg.hop_symbol}")
    out, launches["hopping"] = count_launches(lambda: rx(rx_grid), True, label)
    check_decoded(out, cfg, tb, {}, label, launches["hopping"])
    return launches


def device_events(prof):
    """(kernels, annotation spans) among a profile's device events."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return ([e for e in events if not e.name.startswith("pusch_rx.")],
            [e for e in events if e.name.startswith("pusch_rx.")])


def phase_uci_profile(gen):
    """torch.profiler over 3 calls of the UCI slice at batch 32 (random REs,
    6 iterations, early stop), the launches of each UCI field's decoder at
    batch 32, and the slice's back-to-back time per call (no profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot, decode_uci_field
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.ran.modulation import bits_per_symbol

    calls, dev = 3, torch.cuda.get_device_name(0)
    cfg = northstar_cfg(6, **UCI_FIELDS)
    rx = build_pusch_rx_slot(cfg, "cuda")
    x = torch.randn((32, 4, ofdm.slot_sample_count(cfg.dft_size, cfg.numerology, 0), 2),
                    generator=gen, device="cuda") * 0.3
    rx(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rx(x)
        torch.cuda.synchronize()
    kernels, spans = device_events(prof)
    uci_spans = [e.time_range for e in spans if e.name == "pusch_rx.uci"]
    in_uci = [k for k in kernels
              if any(s.start <= k.time_range.start < s.end for s in uci_spans)]
    host_uci = [e.time_range.elapsed_us() for e in prof.events()
                if e.name == "pusch_rx.uci" and e.device_type == torch.autograd.DeviceType.CPU]
    b2b_ms = cuda_time_ms(lambda: rx(x), reps=5)
    t0 = time.perf_counter()
    for _ in range(5):
        rx(x)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    if not kernels:
        print("profile UCI slice batch 32: not measured (no device events)")
    else:
        print(json.dumps({
            "profile": "pusch_rx_uci_batch32_6it_early-stop",
            "device_kernel_ms_per_call": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls,
            "kernels_per_call": len(kernels) / calls,
            "uci_span_device_ms_per_call": (sum(s.elapsed_us() for s in uci_spans) / 1e3 / calls
                                            if uci_spans else "not measured"),
            "uci_kernel_ms_per_call": sum(k.time_range.elapsed_us() for k in in_uci) / 1e3 / calls,
            "uci_kernels_per_call": len(in_uci) / calls,
            "uci_host_ms_per_call": sum(host_uci) / 1e3 / calls,
            "ldpc_kernel_ms_per_call": sum(e.time_range.elapsed_us() for e in kernels
                                           if "ldpc_decode_kernel" in e.name) / 1e3 / calls,
            "back_to_back_ms_per_call": b2b_ms, "host_wall_ms_per_call": host_ms,
            "device": dev}))
    del x

    qm = bits_per_symbol(cfg.modulation)
    _, info = cfg.demux_plan()
    _, info40 = northstar_cfg(6, nof_harq_ack_bits=40).demux_plan()
    for field, k, e in (("ack", 2, info.nof_harq_ack_bits), ("csi1", 20, info.nof_csi_part1_bits),
                        ("csi2", 48, info.nof_csi_part2_bits),
                        ("ack", 40, info40.nof_harq_ack_bits)):
        llr = torch.randint(-120, 121, (32, e), generator=gen, device="cuda", dtype=torch.int32)
        decode_uci_field(llr, k, qm)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode_uci_field(llr, k, qm)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        kernels, _ = device_events(prof)
        print(json.dumps({"profile": f"uci_field_decode_{field}_{k}bits_e{e}_batch32",
                          "decoder": "short block" if k <= 11 else "CRC + polar",
                          "kernel_launches": len(kernels),
                          "device_kernel_ms": sum(x.time_range.elapsed_us() for x in kernels) / 1e3,
                          "host_ms_under_profiler": host, "device": dev}))


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
    sweep_err = phase_all_sizes(gen)
    layers = phase_tx(fx)
    fx_launches = phase_fixed_slice(layers, fx, gen)
    times = phase_timing(gen)
    phase_profile(gen)
    new_paths = {**phase_uci(gen), **phase_two_phase(gen), **phase_options(fx, gen)}
    print(json.dumps({"ldpc_decode_es_launches_per_call": new_paths}))
    phase_uci_profile(gen)

    rows = [("ldpc_decode_es", ES_REPLACES, es_launches, max(es_err, sweep_err)),
            ("ldpc_decode", FIXED_REPLACES, fx_launches, max(fx_err, sweep_err))]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times[name][0],
        "plain_ms": times[name][1], "bound_ms": times[name][2], "bound_by": times[name][3],
        "library_ms": None, "share_of_bound": times[name][2] / times[name][0]}
        for name, replaces, launches, err in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
