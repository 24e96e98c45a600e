#!/usr/bin/env python3
"""Drive the PyTorch port's UL-SCH transmitter, PUSCH receiver, FAPI entry
point (`UpperPhy.process_ul_slot` and `process_dl_slot`), scaling layer
(`parallel/`: `MultiCellUpperPhy` and the sharded paths), entry module, app
(`apps.gnb_sim`), split-7.2 fronthaul and lower PHY on an NVIDIA GPU and
check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or PATH) and this checkout; imports
nothing of JAX.  Phases, each printing its own lines, keep the numbers the
project's notes cite them by (20 and 24, timing lines nothing read, are
gone); any failure exits non-zero:

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
   field's decoder, and the back-to-back time per call;
14. (a) the FAPI entry point: `UpperPhy(cell, device="cuda").process_ul_slot`
   on a 273-PRB, DFT-4096, 4-rx-port cell with one north-star PUSCH PDU,
   the port's Tx slot mixed onto the ports with AWGN and OFDM-modulated;
   the CRC indication passes, the RxData bits equal the TB, and the call
   launched the early-stop kernel and never the fixed mode;
15. (b) HARQ through the arena: the first transmission of a TB at the first
   noise level (of `HARQ_NOISE`) where it fails, then its retransmission
   (new_data=False, rv 3) at that level, which decodes to the TB and
   releases its reservation, while the retransmission alone does not decode;
16. (c) a mixed slot: a 13-symbol PUSCH PDU narrower than the carrier with a
   2-bit ACK, a 6-bit CSI part 1 and `PART2_MAP` (two-phase), PUCCH
   formats 0 (2 bits + SR), 1 (hopping) and 2 (19 bits, polar), SRS on
   symbol 13 and a 4-port PRACH occasion in a `PrachBuffer`; every
   indication must equal what was sent, the SRS channel within `SRS_TOL` of
   the known gains;
17. (d) for slots (a) and (c) at batch 1, one JSON line each with the card's
   name and power limit: host ms per `process_ul_slot` (median of 12),
   device kernel time, kernel and LDPC launches, stream synchronisations and
   the host ms of the per-PDU sequence generation per slot (torch.profiler);
18. the north-star DL slot (benchmarks/dl_slot_bench.py: 273 PRB, DFT 4096, 4
   tx ports, a 2-layer QAM256 PDSCH precoded by the 4x2 DFT matrix, an
   interleaved AL-4 PDCCH, one SSB, CSI-RS on symbol 13, bf16 grid) through
   `UpperPhy(cell, device="cuda").process_dl_slot`, held against the same
   request through the port on the CPU (grid to `DL_GRID_TOL` of its peak per
   RE, samples to `DL_SAMPLES_REL_RMS`), and the PDCCH candidate
   blind-decoded from the card's grid to its DCI bits;
19. the DL loopback: PDSCH + PDCCH slots at the same PDSCH shape for two UEs
   on one plan, each through `process_dl_slot` on the card, the port's OFDM
   demodulator, the precoder's pseudo-inverse, demap, layer demap,
   descrambling, rate dematching and the early-stop kernel; every CB and the
   TB pass with the bits sent, and the kernel's launches are counted;
21. the scaling layer, `MultiCellUpperPhy(cell, 4, device="cuda")
   .process_ul_slot`: four north-star cells (rnti 0x4601 + c, n_id c + 1)
   in one batched receiver call, every TB decoded, the indications equal to
   four per-cell `UpperPhy` calls and the early-stop launches those of one
   cell; then first transmissions that fail in all four cells and their
   retransmissions (rv `MC_RETX_RV`) combined in the batch through each
   cell's one arena, and the same retransmissions for cells 0-1 in a slot
   whose other cells send another shape, which moves them to the per-cell
   path with their history;
22. `MultiCellUpperPhy.process_dl_slot` on four north-star DL slots of one
   structure (distinct rnti, n_id and sfn) as one batched call, the bf16 grid
   bit for bit and the samples within `MC_DL_SAMPLES_REL_RMS` of per-cell
   `process_dl_slot` on the card; then a set with the last cell's CSI-RS
   left out, through the per-cell fallback, in the same real-pair layout;
23. the sharded paths in a one-rank NCCL group (`make_ran_mesh(1, 1)`):
   the port's entry module, `entry.dryrun_multichip(1)` (the north-star
   slot through `build_ulsch_tx_slot`, the identity FIR of
   `fir_filter_overlap_save`, `sharded_ofdm_demodulate` against
   `ofdm_demodulate`, `build_pusch_rx_from_grid` with early stop, and one
   codeword's codeblocks through `build_sharded_ldpc_decode_es` against the
   unsharded kernel), `build_multi_cell_ulsch_tx` and
   `build_multi_cell_pusch_rx` on the same slot, and `entry.entry()` on a
   high-SNR slot of its own configuration; 76 BG1 z=384 codeblocks through
   `build_sharded_ldpc_decode_es` and `build_sharded_ldpc_decode`, bit for
   bit against the unsharded kernel;
25. the port's app, `apps.gnb_sim.main`, in this process: the `--northstar`
   profile for 8 slots (SSB at slot 0, PRACH at slot 4) with every PUSCH CRC,
   PUCCH F1, the PRACH and every pipelined DL slot passing and 2 early-stop
   launches per PUSCH PDU, and one JSON line of the host ms per DL+UL slot
   pair over slots 2-7 (from its trace); then the default profile, streaming,
   traced, its DL IQ recorded and read back by `FileIqSource`;
26. the split-7.2 fronthaul and the lower PHY: the north-star DL slot of
   phase 18 through `bfp_compress` / `pack_prbs` on the card, U-plane,
   C-plane, eCPRI and VLAN framing and back through the sequence-id and
   rx-window checkers to `unpack_prbs` / `bfp_decompress` (EVM < 1% per
   port, no frame lost, a dropped frame detected), with one JSON line of the
   compress time per slot (CUDA events) and the host framing time; a
   north-star UL slot through `LoopbackGateway` and `LowerPhy.run_ul_slot`
   (CRC OK, 2 early-stop launches) and `LowerPhy.run_dl_slot`'s amplitude
   metrics; the native host library built and in use.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import itertools
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
    span = lambda e: e.name.startswith(("pusch_rx.", "upper_phy.", "dl_slot."))
    return [e for e in events if not span(e)], [e for e in events if span(e)]


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


# ------------------------------------------------------- the FAPI entry point --

#: The FAPI phases drive `UpperPhy.process_ul_slot` on the north-star carrier
#: with 4 rx ports, at this slot of the frame (even: the OFDM phase of slot 0).
FAPI_SLOT = 4
#: Noise levels (per real component, against 0.5 of signal power per port)
#: tried in turn for the HARQ phase's first transmission, from one that
#: decodes to ones that do not; the retransmission goes out at the first
#: level where the first transmission failed.
HARQ_NOISE = tuple(0.018 * 1.04 ** k for k in range(40))
#: The mixed slot's layout on the 273-PRB carrier: PUSCH on PRB 0-199 over
#: symbols 0-12; PUCCH F0 on PRB 200 (symbols 12-13), F1 hopping from PRB 201
#: to PRB 272, F2 on PRB 202-205 (symbols 12-13); SRS on PRB 208-271 of
#: symbol 13; a 4-port long-format PRACH occasion in a `PrachBuffer`.
MIXED_PUSCH_PRB, F0_PRB, F1_PRBS, F2_PRB, SRS_PRB = 200, 200, (201, NS_PRB - 1), 202, 208
CSI1_VALUE = 5  # selects a 24-bit CSI part 2 in PART2_MAP
PRACH_PREAMBLE, PRACH_DELAY = 11, 4.0
#: Bound on |SRS estimate - the port gain it sounds| over the sounded band,
#: relative to the smallest gain: 0.005 noise per component against unit
#: pilots averaged by the estimator's smoothing.
SRS_TOL = 0.05


def fapi_cell():
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig

    return CellConfig(nof_rb=NS_PRB, dft_size=NS_DFT, numerology=1, nof_rx_ports=4)


def northstar_pdu(**kw):
    """The north-star PUSCH PDU: 273 PRB, QAM256 R=948/1024, 2 layers."""
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import PuschPdu
    from srsran_projectvtlmo_tpu_torch.ops.modulation import Modulation

    base = dict(rnti=0x4601, rb_start=0, rb_size=NS_PRB, modulation=Modulation.QAM256,
                target_code_rate=948.0 / 1024.0, nof_layers=2, dmrs_symbols=(2,), n_id=1)
    return PuschPdu(**{**base, **kw})


def pdu_tx_cfg(pdu, slot: int):
    """The UE transmitter's configuration of one PUSCH PDU."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig

    return PuschRxConfig(
        nof_rb=pdu.rb_size, modulation=pdu.modulation, target_code_rate=pdu.target_code_rate,
        nof_layers=pdu.nof_layers, nof_ofdm_symbols=pdu.nof_symbols,
        dmrs_symbols=tuple(s - pdu.start_symbol for s in pdu.dmrs_symbols), rv=pdu.rv,
        rnti=pdu.rnti, n_id=pdu.n_id, start_symbol=pdu.start_symbol, rb_start=pdu.rb_start,
        nof_rx_ports=4, dft_size=NS_DFT, numerology=1, slot=slot,
        nof_harq_ack_bits=pdu.nof_harq_ack_bits, nof_csi_part1_bits=pdu.nof_csi_part1_bits)


def pusch_layers(pdu, slot: int, tb, uci=None, csi2=None) -> torch.Tensor:
    """The port's transmitter for one PDU: (L, nsym, S) complex layer grids."""
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    tx = build_ulsch_tx_slot(pdu_tx_cfg(pdu, slot), "cuda", nof_csi_part2_bits=csi2)
    grid = to_cplx(tx(tb, **(uci or {}))[0])[0]
    return grid.reshape(pdu.nof_layers, pdu.nof_symbols, -1)


def carrier_samples(carrier: torch.Tensor, noise: float, gen) -> np.ndarray:
    """(4, 14, S) complex carrier on the card -> AWGN -> the port's OFDM
    modulator -> (4, nsamples, 2) float32 samples on the host, as a FAPI
    caller hands them over."""
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx

    awgn = torch.complex(torch.randn(carrier.shape, generator=gen, device="cuda"),
                         torch.randn(carrier.shape, generator=gen, device="cuda"))
    samples = ofdm.ofdm_modulate(from_cplx(carrier + noise * awgn), NS_DFT, 1, FAPI_SLOT % 2)
    return samples.cpu().numpy()


def add_pusch(carrier: torch.Tensor, pdu, layers: torch.Tensor) -> None:
    """Mix (L, nsym, S) layer grids onto the 4 ports with `slot_samples`'
    fixed matrix, at the PDU's symbols and PRBs."""
    nl = layers.shape[0]
    p = torch.arange(4, device="cuda", dtype=torch.float32)[:, None]
    l = torch.arange(nl, device="cuda", dtype=torch.float32)[None, :]
    mix = torch.polar(torch.full((4, nl), 0.5, device="cuda"), -2.0 * np.pi * p * l / 4.0)
    k0, s0 = pdu.rb_start * 12, pdu.start_symbol
    carrier[:, s0:s0 + pdu.nof_symbols, k0:k0 + layers.shape[-1]] += torch.einsum(
        "pl,lsk->psk", mix, layers)


def indications(inds, cls: str) -> list:
    return [i for i in inds if type(i).__name__ == cls]


def check_pusch(inds, tb: torch.Tensor, label: str) -> None:
    crc = indications(inds, "CrcIndication")
    rxd = indications(inds, "RxDataIndication")
    bits = rxd[0].tb_bits if rxd else None
    errors = int((bits != tb.cpu().numpy()[0]).sum()) if bits is not None else None
    print(f"{label}: tb_crc_ok {[c.tb_crc_ok for c in crc]}, TB bit errors {errors}")
    if len(crc) != 1 or not crc[0].tb_crc_ok or errors != 0:
        raise SystemExit(f"{label}: the PUSCH PDU did not decode to the TB sent")


def phase_fapi_northstar(gen, smi: str) -> dict:
    """(a) The north-star PUSCH PDU through `UpperPhy.process_ul_slot`."""
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import UlTtiRequest
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import ExpertPhyConfig, UpperPhy

    phy = UpperPhy(fapi_cell(), ExpertPhyConfig(pusch_decoder_max_iterations=6), device="cuda")
    pdu = northstar_pdu()
    tb = random_tb(pdu_tx_cfg(pdu, FAPI_SLOT), 1, gen)
    carrier = torch.zeros((4, 14, NS_PRB * 12), dtype=torch.complex64, device="cuda")
    add_pusch(carrier, pdu, pusch_layers(pdu, FAPI_SLOT, tb))
    samples = carrier_samples(carrier, 0.005, gen)
    request = UlTtiRequest(slot=FAPI_SLOT, pusch=(pdu,))
    phy.process_ul_slot(request, samples)  # builds the receiver, moves its tables
    label = "FAPI north-star slot (process_ul_slot, 273 PRB QAM256 4x2)"
    inds, launches = count_launches(lambda: phy.process_ul_slot(request, samples), True, label)
    check_pusch(inds, tb, label + f", kernel launches {launches}")
    fapi_timing(phy, request, samples, None, "northstar", smi)
    return {"fapi_northstar": launches}


def phase_fapi_harq(gen) -> dict:
    """(b) A TB that fails at its first transmission, then its retransmission
    (new_data=False, rv 3) combined through the HARQ arena."""
    import dataclasses

    from srsran_projectvtlmo_tpu_torch.fapi.pdus import UlTtiRequest
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    phy = UpperPhy(fapi_cell(), device="cuda")
    first = northstar_pdu(harq_id=5)
    again = dataclasses.replace(first, new_data=False, rv=3)
    tb = random_tb(pdu_tx_cfg(first, FAPI_SLOT), 1, gen)
    slots = {}
    for pdu in (first, again):
        carrier = torch.zeros((4, 14, NS_PRB * 12), dtype=torch.complex64, device="cuda")
        add_pusch(carrier, pdu, pusch_layers(pdu, FAPI_SLOT, tb))
        slots[pdu.rv] = carrier
    tried = []
    for noise in HARQ_NOISE:
        inds = phy.process_ul_slot(UlTtiRequest(slot=FAPI_SLOT, pusch=(first,)),
                                   carrier_samples(slots[0], noise, gen))
        tried.append(round(noise, 5))
        if not indications(inds, "CrcIndication")[0].tb_crc_ok:
            break
    else:
        raise SystemExit(f"HARQ: the first transmission decoded at every noise level {tried}")
    if phy.harq_pool.nof_reserved != 1:
        raise SystemExit(f"HARQ: {phy.harq_pool.nof_reserved} reservations after a failed TB")
    retx = carrier_samples(slots[3], noise, gen)
    alone = UpperPhy(fapi_cell(), device="cuda").process_ul_slot(
        UlTtiRequest(slot=FAPI_SLOT, pusch=(again,)), retx)
    label = (f"HARQ retransmission (rv 3, new_data=False) at noise {noise:.5f}, after the "
             f"first transmission failed (noise levels tried {tried})")
    inds, launches = count_launches(lambda: phy.process_ul_slot(
        UlTtiRequest(slot=FAPI_SLOT, pusch=(again,)), retx), True, label)
    check_pusch(inds, tb, label + f"; kernel launches {launches}")
    alone_ok = indications(alone, "CrcIndication")[0].tb_crc_ok
    print(f"the retransmission alone, without the arena's history: tb_crc_ok {alone_ok}; "
          f"reservations after the pass {phy.harq_pool.nof_reserved}")
    if alone_ok or phy.harq_pool.nof_reserved != 0:
        raise SystemExit("HARQ: the retransmission decoded without its history, or the "
                         "reservation was not released after the pass")
    return {"fapi_harq_retransmission": launches}


def pucch_cyclic_shift(n_id: int, slot: int, symbol: int) -> int:
    """n_cs(n_s, l) of TS 38.211 Section 6.3.2.2.2: eight Gold bits from
    c_init = n_id at offset 8 (14 n_s + l).  The PUCCH generators below use
    only the sequence modules (`low_papr`, `prg`, `uci`), none of the
    detector's own tables, so the card check holds those tables too."""
    from srsran_projectvtlmo_tpu_torch.ops import prg

    off = 8 * (14 * slot + symbol)
    return int(sum(int(b) << i for i, b in enumerate(prg.gold_sequence_bits(n_id, off + 8)[off:])))


def pucch_base(cfg, shift: int, symbol: int) -> np.ndarray:
    """The 12-RE low-PAPR sequence of one PUCCH symbol at cyclic shift
    (m0 + shift + n_cs) mod 12."""
    from srsran_projectvtlmo_tpu_torch.ops import low_papr

    u, v = low_papr.pucch_group_sequence(cfg.n_id)
    ncs = pucch_cyclic_shift(cfg.n_id, cfg.slot, cfg.start_symbol + symbol)
    return low_papr.low_papr_sequence(
        u, v, 2 * np.pi * ((cfg.initial_cyclic_shift + shift + ncs) % 12) / 12, 12)


def pucch_res_f0(cfg, bits) -> np.ndarray:
    """(S, 12) PUCCH format-0 REs for 2 HARQ bits (Gray-mapped cyclic shift,
    TS 38.213 Table 9.2.3-4)."""
    mcs = (0, 3, 9, 6)[2 * bits[0] + bits[1]]
    return np.stack([pucch_base(cfg, mcs, s) for s in range(cfg.nof_symbols)])


#: TS 38.211 Table 6.3.2.4.1-2, phi(m) of OCC index 1 for the hop lengths
#: the mixed slot uses: w(m) = exp(2 pi j phi(m) / N).
OCC1_PHI = {3: (0, 1, 2), 4: (0, 2, 0, 2)}


def pucch_res_f1(cfg, bits) -> np.ndarray:
    """(S, 12) PUCCH format-1 REs for 2 HARQ bits (QPSK d, TS 38.211
    Section 6.3.2.4): DM-RS on the even symbols and data on the odd ones,
    each hop (floor(S/2) symbols first) spread by its own OCC."""
    assert cfg.time_domain_occ == 1 and cfg.intra_slot_hopping
    d = ((1 - 2 * bits[0]) + 1j * (1 - 2 * bits[1])) / np.sqrt(2)
    res = np.zeros((cfg.nof_symbols, 12), np.complex64)
    half = cfg.nof_symbols // 2
    for a, b in ((0, half), (half, cfg.nof_symbols)):
        for parity, value in ((0, 1.0), (1, d)):
            syms = [s for s in range(a, b) if s % 2 == parity]
            phi = OCC1_PHI[len(syms)]
            for m, s in enumerate(syms):
                res[s] = value * np.exp(2j * np.pi * phi[m] / len(syms)) * pucch_base(cfg, 0, s)
    return res


def pucch_res_f2(cfg, msg) -> np.ndarray:
    """(S, 12 * PRB) PUCCH format-2 REs: UCI-encoded, scrambled QPSK on the
    REs other than 3m + 1 of each RB, and the DM-RS of TS 38.211 Section
    6.4.1.3.2 there, indexed from the allocation's first RB."""
    from srsran_projectvtlmo_tpu_torch.ops import prg, uci

    prb, nsym = cfg.nof_prb, cfg.nof_symbols
    e = 16 * prb * nsym
    scr = uci.uci_encode(msg, e, bits_per_symbol=2) ^ prg.gold_sequence_bits(
        ((cfg.rnti << 15) + cfg.n_id) & 0x7FFFFFFF, e)
    qpsk = ((1 - 2 * scr[0::2].astype(np.float64)) + 1j * (1 - 2 * scr[1::2])) / np.sqrt(2)
    dmrs_re = np.zeros(12 * prb, bool)
    dmrs_re[1::3] = True
    res = np.zeros((nsym, 12 * prb), np.complex64)
    res[:, ~dmrs_re] = qpsk.reshape(nsym, 8 * prb)
    for s in range(nsym):
        n_id0 = cfg.n_id0
        cinit = ((1 << 17) * (14 * cfg.slot + cfg.start_symbol + s + 1) * (2 * n_id0 + 1)
                 + 2 * n_id0) % (1 << 31)
        c = 1 - 2 * prg.gold_sequence_bits(cinit, 8 * prb).astype(np.float64)
        res[s, dmrs_re] = (c[0::2] + 1j * c[1::2]) / np.sqrt(2)
    return res


def prach_occasion(cfg, gains: np.ndarray, gen_np) -> np.ndarray:
    """(P, L, 2) received long-format occasion: the preamble delayed by
    PRACH_DELAY samples through each port's gain, at 3 dB SNR."""
    from srsran_projectvtlmo_tpu_torch.ops import prach
    from srsran_projectvtlmo_tpu_torch.utils.cplx import np_to_pair

    n = np.arange(cfg.sequence_length)
    freq = prach.prach_generate(cfg, PRACH_PREAMBLE) * np.exp(
        -2j * np.pi * n * PRACH_DELAY / cfg.sequence_length)
    rx = 10 ** (3 / 20) * gains[:, None] * freq[None]
    rx = rx + (gen_np.normal(size=rx.shape) + 1j * gen_np.normal(size=rx.shape)) / np.sqrt(2)
    return np_to_pair(rx.astype(np.complex64))


def phase_fapi_mixed(gen, smi: str) -> dict:
    """(c) One slot with every UL PDU kind; every indication must be what
    was sent."""
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import PrachPdu, PucchPdu, SrsPdu, UlTtiRequest
    from srsran_projectvtlmo_tpu_torch.ops import prach, srs
    from srsran_projectvtlmo_tpu_torch.phy import pucch
    from srsran_projectvtlmo_tpu_torch.phy.prach_buffer import PrachBuffer, PrachBufferFormat
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    rng = np.random.default_rng(5)
    slot, cell = FAPI_SLOT, fapi_cell()
    pusch_pdu = northstar_pdu(rb_size=MIXED_PUSCH_PRB, nof_symbols=13, nof_harq_ack_bits=2,
                              nof_csi_part1_bits=6, part2_size_map=PART2_MAP)
    csi2 = PART2_MAP[CSI1_VALUE]
    tb = random_tb(pdu_tx_cfg(pusch_pdu, slot), 1, gen)
    sent = {"ack_bits": np.array([1, 0], np.uint8),
            "csi1_bits": np.array([(CSI1_VALUE >> (5 - i)) & 1 for i in range(6)], np.uint8),
            "csi2_bits": rng.integers(0, 2, csi2).astype(np.uint8),
            "f0": (1, 1), "f1": (0, 1), "f2": rng.integers(0, 2, 19).astype(np.uint8)}
    uci = {k: torch.as_tensor(sent[k][None], device="cuda")
           for k in ("ack_bits", "csi1_bits", "csi2_bits")}
    carrier = torch.zeros((4, 14, NS_PRB * 12), dtype=torch.complex64, device="cuda")
    add_pusch(carrier, pusch_pdu, pusch_layers(pusch_pdu, slot, tb, uci, csi2))

    pdus = {
        "f0": PucchPdu(format=0, rnti=0x51, prb_start=F0_PRB, nof_prb=1, start_symbol=12,
                       nof_symbols=2, initial_cyclic_shift=3, nof_harq_bits=2,
                       sr_opportunity=True, n_id=cell.phys_cell_id),
        "f1": PucchPdu(format=1, rnti=0x52, prb_start=F1_PRBS[0], nof_prb=1, start_symbol=0,
                       nof_symbols=14, initial_cyclic_shift=2, time_domain_occ=1,
                       nof_harq_bits=2, n_id=cell.phys_cell_id, second_hop_prb=F1_PRBS[1]),
        "f2": PucchPdu(format=2, rnti=0x53, prb_start=F2_PRB, nof_prb=4, start_symbol=12,
                       nof_symbols=2, nof_uci_bits=19, n_id=9, n_id0=11)}
    f0 = pucch.PucchFormat0Config(n_id=cell.phys_cell_id, slot=slot, start_symbol=12,
                                  nof_symbols=2, initial_cyclic_shift=3, nof_harq_bits=2,
                                  sr_opportunity=True)
    f1 = pucch.PucchFormat1Config(n_id=cell.phys_cell_id, slot=slot, start_symbol=0,
                                  nof_symbols=14, initial_cyclic_shift=2, time_domain_occ=1,
                                  nof_harq_bits=2, intra_slot_hopping=True)
    f2 = pucch.PucchFormat2Config(n_id=9, n_id0=11, rnti=0x53, slot=slot, start_symbol=12,
                                  nof_symbols=2, nof_prb=4, nof_uci_bits=19)
    srs_pdu = SrsPdu(rnti=0x54, nof_rb=NS_PRB - 1 - SRS_PRB, prb_start=SRS_PRB, comb_size=2,
                     start_symbol=13, sequence_id=5)
    scfg = srs.SrsConfig(nof_rb=srs_pdu.nof_rb, comb_size=2, start_symbol=13, sequence_id=5)
    srs_res = np.zeros((1, scfg.nof_rb * 12), np.complex64)
    srs_res[:, srs.srs_subcarriers(scfg)] = srs.srs_sequence(scfg)
    gains = (rng.normal(size=4) + 1j * rng.normal(size=4)) / np.sqrt(2) + 0.5
    res = np.zeros((4, 14, NS_PRB * 12), np.complex64)
    g = gains[:, None, None]
    res[:, 12:14, F0_PRB * 12:(F0_PRB + 1) * 12] = g * pucch_res_f0(f0, sent["f0"])
    f1_res = pucch_res_f1(f1, sent["f1"])
    res[:, 0:7, F1_PRBS[0] * 12:(F1_PRBS[0] + 1) * 12] = g * f1_res[:7]
    res[:, 7:14, F1_PRBS[1] * 12:(F1_PRBS[1] + 1) * 12] = g * f1_res[7:]
    res[:, 12:14, F2_PRB * 12:(F2_PRB + 4) * 12] = g * pucch_res_f2(f2, sent["f2"])
    res[:, 13:14, SRS_PRB * 12:(SRS_PRB + scfg.nof_rb) * 12] = g * srs_res
    carrier += torch.as_tensor(res, device="cuda")
    samples = carrier_samples(carrier, 0.005, gen)

    pcfg = prach.PrachDetectorConfig(sequence_length=prach.LONG, root_sequence_index=22,
                                     zero_correlation_zone=11)
    buf = PrachBuffer(PrachBufferFormat(sequence_length=prach.LONG, nof_ports=4), 0)
    buf.set_symbol(0, 0, prach_occasion(pcfg, gains, rng))
    request = UlTtiRequest(slot=slot, pusch=(pusch_pdu,), pucch=tuple(pdus.values()),
                           srs=(srs_pdu,), prach=(PrachPdu(root_sequence_index=22,
                                                           zero_correlation_zone=11),))
    phy = UpperPhy(cell, device="cuda")
    phy.process_ul_slot(request, samples, buf)  # builds the receivers, moves their tables
    label = "FAPI mixed slot"
    inds, launches = count_launches(lambda: phy.process_ul_slot(request, samples, buf), True,
                                    label)

    names = [type(i).__name__ for i in inds]
    want = ["CrcIndication", "RxDataIndication"] + ["UciIndication"] * 4 + \
        ["SrsIndication", "RachIndication"]
    if names != want:
        raise SystemExit(f"{label}: indications {names}, expected {want}")
    check_pusch(inds, tb, f"{label}: PUSCH {MIXED_PUSCH_PRB} PRB x 13 symbols QAM256 4x2 "
                          f"with ACK 2, CSI 6 + {csi2} (two-phase)")
    pusch_uci, u0, u1, u2 = inds[2:6]
    srs_ind, rach = inds[6], inds[7]
    checks = {
        "PUSCH ACK": pusch_uci.valid and np.array_equal(pusch_uci.harq_bits, sent["ack_bits"]),
        "PUSCH CSI 1": pusch_uci.csi1_valid and np.array_equal(pusch_uci.csi1_bits,
                                                              sent["csi1_bits"]),
        "PUSCH CSI 2": pusch_uci.csi2_valid and np.array_equal(pusch_uci.csi2_bits,
                                                              sent["csi2_bits"]),
        "PUCCH F0 (2 bits + SR)": u0.valid and u0.sr_detected and tuple(u0.harq_bits) == sent["f0"],
        "PUCCH F1 (hopping)": u1.valid and tuple(u1.harq_bits) == sent["f1"],
        "PUCCH F2 (19 bits)": u2.valid and np.array_equal(u2.uci_bits, sent["f2"]),
    }
    srs_err = float(np.abs(srs_ind.channel - gains[:, None]).max() / np.abs(gains).min())
    checks[f"SRS channel ({srs_ind.channel.shape}), max error {srs_err:.4f} of the smallest "
           f"gain (bound {SRS_TOL})"] = srs_err <= SRS_TOL
    best = max(rach.preambles, key=lambda d: d[2]) if rach.preambles else (None, None, None)
    checks[f"PRACH preamble {best[0]} TA {best[1]} samples (sent {PRACH_PREAMBLE}, "
           f"{PRACH_DELAY})"] = best[0] == PRACH_PREAMBLE and abs(best[1] - PRACH_DELAY) <= 1.0
    for name, ok in checks.items():
        print(f"{label}: {name}: {'ok' if ok else 'WRONG'}")
    if not all(checks.values()):
        raise SystemExit(f"{label}: an indication differs from what was sent")
    print(f"{label}: kernel launches {launches}")
    fapi_timing(phy, request, samples, buf, "mixed", smi)
    return {"fapi_mixed": launches}


def fapi_timing(phy, request, samples, prach_samples, label: str, smi: str) -> None:
    """(d) Host ms per `process_ul_slot` (median of 12 calls, each ending in
    the indications on the host), then `torch.profiler` over 3 calls: device
    kernel time and launches per slot, the LDPC kernel's launches and time,
    stream synchronisations per slot, and the host time inside the per-PDU
    sequence generation (the `upper_phy.pusch_sequences` span)."""
    from torch.profiler import ProfilerActivity, profile

    call = lambda: phy.process_ul_slot(request, samples, prach_samples)
    host_ms = []
    for _ in range(12):
        t0 = time.perf_counter()
        call()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
    kernels, _ = device_events(prof)
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    seq_ms = sum(e.time_range.elapsed_us() for e in cpu
                 if e.name == "upper_phy.pusch_sequences") / 1e3 / calls
    ldpc = [e for e in kernels if "ldpc_decode_kernel" in e.name]
    print(json.dumps({
        "profile": f"upper_phy_process_ul_slot_{label}_batch1",
        "host_ms_per_slot": float(np.median(host_ms)), "host_ms_calls": host_ms,
        "device_kernel_ms_per_slot": (sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                                      / calls if kernels else "not measured"),
        "kernels_per_slot": len(kernels) / calls if kernels else "not measured",
        "ldpc_launches_per_slot": len(ldpc) / calls if kernels else "not measured",
        "ldpc_kernel_ms_per_slot": sum(e.time_range.elapsed_us() for e in ldpc) / 1e3 / calls,
        "stream_syncs_per_slot": sum(e.name == "cudaStreamSynchronize" for e in cpu) / calls,
        "sequence_host_ms_per_slot": seq_ms,
        "device": torch.cuda.get_device_name(0), "card": smi}))


# ----------------------------------------------------------------- the DL slot --

#: The north-star DL slot (benchmarks/dl_slot_bench.py): 273 PRB, DFT 4096, 4 tx
#: ports, slot 2; a 2-layer QAM256 R=948/1024 PDSCH on symbols 2-13 (DM-RS on
#: 2) precoded by the 4x2 DFT matrix, a 40-bit DCI at AL 4 on symbol 1 of an
#: interleaved 48-RB CORESET, one SSB (PCI 1, block 0) and a 273-RB CSI-RS of
#: the PDU's default row (2) on symbol 13 at subcarrier offset 3.
DL_SLOT = 2
DL_W = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2.0
#: The two UEs of the loopback: (rnti, n_id).
DL_UES = ((0x4601, 1), (0x2B67, 500))
#: Card against CPU, both `grid_bf16`: per RE, one bf16 step of the grid's
#: peak (2^-8: where the two float32 sums differ in their last bit, they may
#: round to neighbouring bf16 values); the samples to 1e-4 relative RMS (the
#: FFTs sum in another order; a flipped bf16 RE adds about 2^-8 of one RE).
DL_GRID_TOL = 2.0 ** -8
DL_SAMPLES_REL_RMS = 1e-4
#: Noise variance the PDCCH decoder and the PDSCH demapper assume: the grid's
#: only noise is the bf16 quantization (<= 2^-9 of the peak per component).
DL_NOISE_VAR = 1e-3


def dl_cell():
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig

    return CellConfig(nof_rb=NS_PRB, dft_size=NS_DFT, numerology=1, nof_tx_ports=4)


def dl_request(rnti: int, n_id: int, seed: int, ssb_csi: bool = True, sfn: int = 0,
               csi_rs: bool = True):
    """(DlTtiRequest, TxDataRequest, DCI bits) of the north-star DL slot for
    one UE, the TB and the DCI drawn from `seed`; without `ssb_csi`, no SSB
    and no CSI-RS, without `csi_rs` no CSI-RS; the SSB's PBCH carries `sfn`."""
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import (
        CsiRsPdu, DlTtiRequest, PdcchPdu, PdschPdu, SsbPdu, TxDataRequest)
    from srsran_projectvtlmo_tpu_torch.ops.modulation import Modulation
    from srsran_projectvtlmo_tpu_torch.phy.dl_slot import get_dl_slot_program

    rng = np.random.default_rng(seed)
    dci = rng.integers(0, 2, 40).astype(np.uint8)
    pdcch = PdcchPdu(rnti=rnti, nof_dci_bits=40, aggregation_level=4, cce_index=0,
                     start_symbol=1, n_id=n_id, n_rnti=rnti, coreset_nof_rb=48, interleaved=True)
    object.__setattr__(pdcch, "payload", tuple(int(b) for b in dci))  # the DCI the slot sends
    pdsch = PdschPdu(rnti=rnti, rb_start=0, rb_size=NS_PRB, modulation=Modulation.QAM256,
                     target_code_rate=948 / 1024, nof_layers=2, start_symbol=2, nof_symbols=12,
                     dmrs_symbols=(2,), n_id=n_id,
                     precoding=tuple(tuple((float(c.real), float(c.imag)) for c in row)
                                     for row in DL_W))
    extra = {}
    if ssb_csi:
        extra["ssb"] = (SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=sfn,
                               half_radio_frame=False),)
        if csi_rs:
            extra["csi_rs"] = (CsiRsPdu(nof_rb=NS_PRB, symbol=13, subcarrier_offset=3),)
    req = DlTtiRequest(slot=DL_SLOT, pdcch=(pdcch,), pdsch=(pdsch,), **extra)
    tbs = get_dl_slot_program(req, dl_cell(), "cpu").pdsch_cfgs[0].tbs
    return req, TxDataRequest(slot=DL_SLOT, tb_bits=[rng.integers(0, 2, tbs).astype(np.uint8)]), dci


def decode_pdcch(grid: torch.Tensor, req, cell) -> tuple[bool, np.ndarray]:
    """Blind-decode the request's PDCCH candidate from port 0 of a (4, 14, S)
    complex grid on the card: (CRC flag, DCI bits)."""
    from srsran_projectvtlmo_tpu_torch.phy import pdcch as pdcch_mod
    from srsran_projectvtlmo_tpu_torch.phy.dl_slot import _pdcch_plan
    from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx

    pdu = req.pdcch[0]
    _, data_idx, _ = _pdcch_plan(pdu, cell)
    re = grid[0].reshape(-1)[torch.as_tensor(data_idx, device=grid.device, dtype=torch.int64)]
    bits, ok = pdcch_mod.pdcch_blind_decode(
        from_cplx(re)[None], torch.full((1, re.shape[0]), DL_NOISE_VAR, device=grid.device),
        pdcch_mod.PdcchCandidateConfig(nof_dci_bits=pdu.nof_dci_bits,
                                       aggregation_level=pdu.aggregation_level, rnti=pdu.rnti,
                                       n_id=pdu.n_id, n_rnti=pdu.n_rnti))
    return bool(ok[0]), bits[0].cpu().numpy()


def phase_dl_northstar(smi: str):
    """(18) The north-star DL slot through `UpperPhy.process_dl_slot` on the
    card, held against the same request through the port on the CPU; the
    PDCCH candidate decoded from the card's grid.  Returns (phy, request,
    tx_data) for the timing phase."""
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    cell = dl_cell()
    req, data, dci = dl_request(*DL_UES[0], seed=18)
    phy = UpperPhy(cell, device="cuda")
    phy.process_dl_slot(req, data)  # builds the plan, moves its index tables
    grid, samples = phy.process_dl_slot(req, data)
    t0 = time.perf_counter()
    cpu_grid, cpu_samples = UpperPhy(cell, device="cpu").process_dl_slot(req, data)
    cpu_s = time.perf_counter() - t0
    nsamp = ofdm.slot_sample_count(NS_DFT, 1, DL_SLOT % 2)
    shapes_ok = grid.shape == (4, 14, NS_PRB * 12) and samples.shape == (4, nsamp, 2)
    finite = bool(np.isfinite(grid).all() and np.isfinite(samples).all())
    peak = float(np.abs(cpu_grid).max())
    grid_err = float(np.abs(grid - cpu_grid).max()) / peak
    rel = float(np.sqrt(np.mean((samples - cpu_samples) ** 2) / np.mean(cpu_samples ** 2)))
    ok, bits = decode_pdcch(torch.as_tensor(grid, device="cuda"), req, cell)
    dci_ok = ok and bool((bits == dci).all())
    print(f"DL north-star slot (process_dl_slot, {NS_PRB} PRB, 4 ports, PDSCH 2 layers QAM256 + "
          f"PDCCH + SSB + CSI-RS, bf16 grid): grid {grid.shape}, samples {samples.shape}, "
          f"max |card - CPU| / peak {grid_err:.3g} (bound {DL_GRID_TOL:.3g}), samples "
          f"relative RMS {rel:.3g} (bound {DL_SAMPLES_REL_RMS}), PDCCH from the card's grid: "
          f"crc_ok {ok}, DCI equal {dci_ok}; the CPU port took {cpu_s:.1f} s; {smi}")
    if not (shapes_ok and finite and grid_err <= DL_GRID_TOL and rel <= DL_SAMPLES_REL_RMS
            and dci_ok):
        raise SystemExit("the card's north-star DL slot differs from the port on the CPU")
    return phy, req, data


def dl_receive(samples: torch.Tensor, pdu, cfg):
    """The DL loopback's receiver on the card: (4, nsamples, 2) samples -> the
    port's OFDM demodulator -> the precoder's pseudo-inverse on the PDSCH
    data REs -> layer demap -> demap -> descramble with the PDU's rnti/n_id
    -> rate dematch -> the early-stop kernel -> CB and TB CRCs.
    Returns (tb_crc_ok, cb_crc_ok (C,), TB bits)."""
    from srsran_projectvtlmo_tpu_torch.ops import ofdm, prg
    from srsran_projectvtlmo_tpu_torch.ops.demodulation import soft_demap
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode_cuda
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import rate_match as rm
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.segment import desegment_rx
    from srsran_projectvtlmo_tpu_torch.ops.precoding import layer_demap
    from srsran_projectvtlmo_tpu_torch.ran.modulation import bits_per_symbol
    from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx, to_cplx

    dev = samples.device
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    grid = ofdm.ofdm_demodulate(samples, NS_PRB * 12, NS_DFT, 1, DL_SLOT % 2)
    data_syms = [pdu.start_symbol + s for s in cfg.data_symbols]
    k0 = pdu.rb_start * 12
    y = to_cplx(grid[:, data_syms, k0:k0 + cfg.nof_subc]).reshape(4, -1)  # (P, M)
    w = torch.as_tensor(DL_W.astype(np.complex64), device=dev)
    x = layer_demap(torch.linalg.pinv(w) @ y)  # (G / Qm,)
    llr = soft_demap(from_cplx(x)[None], torch.full((1, x.shape[0]), DL_NOISE_VAR, device=dev),
                     cfg.modulation)[0]
    cinit = ((pdu.rnti << 15) + pdu.n_id) & 0x7FFFFFFF
    signs = torch.as_tensor(1 - 2 * prg.gold_sequence_bits(cinit, cfg.nof_codeword_bits)
                            .astype(np.int32), device=dev)
    llr = torch.clamp(llr.to(torch.int32) * signs, -127, 127).to(torch.int8)
    crc_cb = "CRC24B" if seg.cb_crc_bits else ("CRC24A" if seg.tb_crc_bits == 24 else "CRC16")
    hards, oks, off = [], [], 0
    for e, run in itertools.groupby(cfg.cb_rate_match_sizes()):  # equal-E codeblock groups
        nj = len(list(run))
        soft = rm.rate_dematch(llr[off:off + nj * e].reshape(nj, e), seg.base_graph,
                               seg.lifting_size, seg.nof_filler_bits_per_cb, pdu.rv, e, qm)
        h, _, ok, _ = decode_cuda.ldpc_decode_es(soft.contiguous(), seg.base_graph,
                                                 seg.lifting_size, crc_cb,
                                                 seg.nof_payload_bits_per_cb, nof_iterations=6)
        hards.append(h)
        oks.append(ok)
        off += nj * e
    tb, tb_ok, cb_ok = desegment_rx(torch.cat(hards), seg, cfg.tbs)
    return bool(tb_ok), (cb_ok & torch.cat(oks)).cpu().numpy(), tb.cpu().numpy()


def phase_dl_loopback() -> dict:
    """(19) PDSCH + PDCCH slots at the north-star PDSCH shape (no SSB or CSI-RS
    over the PDSCH) for two UEs on one plan: `process_dl_slot` on the card,
    then `dl_receive`; every CB and the TB pass and the bits equal the TB
    sent, with the early-stop kernel launched."""
    from srsran_projectvtlmo_tpu_torch.phy import dl_slot
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    cell = dl_cell()
    phy = UpperPhy(cell, device="cuda")
    launches, plans = {}, set()
    for k, (rnti, n_id) in enumerate(DL_UES):
        req, data, _ = dl_request(rnti, n_id, seed=19 + k, ssb_csi=False)
        program = dl_slot.get_dl_slot_program(req, cell, "cuda")
        plans.add(id(program))
        cfg = program.pdsch_cfgs[0]
        label = f"DL loopback, UE rnti {rnti:#x} n_id {n_id} ({NS_PRB} PRB QAM256 4x2, bf16 grid)"

        def loop():
            _, samples = phy.process_dl_slot(req, data, fetch=False)
            return dl_receive(samples, req.pdsch[0], cfg)

        loop()  # the first call builds the plan's tables on the card
        (tb_ok, cb_ok, tb), n = count_launches(loop, True, label)
        errors = int((tb != data.tb_bits[0]).sum())
        print(f"{label}: tb_crc_ok {tb_ok}, cb_crc_ok {int(cb_ok.sum())}/{cb_ok.size}, "
              f"TB bit errors {errors}, kernel launches {n}")
        if not (tb_ok and cb_ok.all() and errors == 0):
            raise SystemExit(f"{label}: the PDSCH did not decode to the TB sent")
        launches[f"dl_loopback_ue{k + 1}"] = n
    if len(plans) != 1:
        raise SystemExit(f"the two UEs used {len(plans)} DL plans, not one")
    return launches


# ------------------------------------------------------- the scaling layer --

#: The multi-cell phases: four cells of the north-star carrier, cell c's UE
#: at rnti 0x4601 + c, n_id c + 1 (benchmarks/multi_cell_bench.py:54-58).
MC_CELLS = 4
#: The redundancy version of the multi-cell retransmissions: 3, as phase
#: 15's. At this code rate an rv-2 retransmission need not recover what its
#: first transmission lost: on an H100 one of the four cells stayed
#: undecoded after combining at rv 2 (ROADMAP Queue C observes the same at
#: 24 PRB, in JAX and the port).
MC_RETX_RV = 3
#: Sharded OFDM demodulation against the unsharded one (tests/test_parallel.py).
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-5
#: DL samples of the batched call against per-cell dispatch, relative RMS.
MC_DL_SAMPLES_REL_RMS = 1e-6


def same_indications(a: list, b: list) -> bool:
    """Two indication lists equal type by type and field by field."""
    import dataclasses

    if [type(i).__name__ for i in a] != [type(i).__name__ for i in b]:
        return False
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                if u is None or v is None or not np.array_equal(u, v):
                    return False
            elif u != v:
                return False
    return True


def mc_samples(pdus, tbs, noises, gen) -> np.ndarray:
    """(ncell, 4, nsamples, 2): each cell's PDU from the port's Tx, mixed onto
    the 4 ports, AWGN at its noise level, OFDM (`carrier_samples`)."""
    out = []
    for pdu, tb, noise in zip(pdus, tbs, noises):
        carrier = torch.zeros((4, 14, NS_PRB * 12), dtype=torch.complex64, device="cuda")
        add_pusch(carrier, pdu, pusch_layers(pdu, FAPI_SLOT, tb))
        out.append(carrier_samples(carrier, noise, gen))
    return np.stack(out)


def check_cells(inds: list, tbs: list, label: str) -> None:
    for c, tb in enumerate(tbs):
        check_pusch(inds[c], tb, f"{label}, cell {c}")


def phase_multi_cell_ul(gen) -> dict:
    """(21) `MultiCellUpperPhy.process_ul_slot`: four north-star cells in one
    batched receiver call, equal to four per-cell `UpperPhy` calls; then
    HARQ: first transmissions that fail (each cell at its first failing
    level of HARQ_NOISE, as phase 15), retransmissions (rv MC_RETX_RV)
    combined in the batch, and retransmissions that leave the batch for the
    per-cell path in a slot where the other cells' PDUs differ."""
    import dataclasses

    from srsran_projectvtlmo_tpu_torch.fapi.pdus import UlTtiRequest
    from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    cell = fapi_cell()
    pdus = [northstar_pdu(rnti=0x4601 + c, n_id=c + 1) for c in range(MC_CELLS)]
    tbs = [random_tb(pdu_tx_cfg(p, FAPI_SLOT), 1, gen) for p in pdus]
    samples = mc_samples(pdus, tbs, [0.005] * MC_CELLS, gen)
    reqs = [UlTtiRequest(slot=FAPI_SLOT, pusch=(p,)) for p in pdus]
    mc = MultiCellUpperPhy(cell, MC_CELLS, device="cuda")
    mc.process_ul_slot(reqs, samples)  # builds the receiver, moves its tables
    label = f"multi-cell UL, {MC_CELLS} north-star cells in one batched call"
    inds, launches = count_launches(lambda: mc.process_ul_slot(reqs, samples), True, label)
    check_cells(inds, tbs, label)
    one = UpperPhy(cell, device="cuda")
    ref, one_launches = count_launches(lambda: [one.process_ul_slot(reqs[c], samples[c])
                                                for c in range(MC_CELLS)], True, "per-cell")
    equal = all(same_indications(inds[c], ref[c]) for c in range(MC_CELLS))
    print(f"{label}: early-stop launches {launches} per batched call ({one_launches} for "
          f"{MC_CELLS} per-cell calls); indications equal to per-cell dispatch: {equal}")
    if not equal or launches != one_launches // MC_CELLS:
        raise SystemExit(f"{label}: indications differ from per-cell dispatch, or the batch "
                         f"launched {launches} times, not {one_launches // MC_CELLS}")

    first = [dataclasses.replace(p, harq_id=5) for p in pdus]
    again = [dataclasses.replace(p, new_data=False, rv=MC_RETX_RV) for p in first]
    # Each cell's first transmission at the first noise level (of
    # HARQ_NOISE) where it fails, those samples kept.
    probe, tried = MultiCellUpperPhy(cell, MC_CELLS, device="cuda"), []
    levels, slot_a = [None] * MC_CELLS, [None] * MC_CELLS
    first_reqs = [UlTtiRequest(slot=FAPI_SLOT, pusch=(p,)) for p in first]
    for noise in HARQ_NOISE:
        if all(lv is not None for lv in levels):
            break
        samples_n = mc_samples(first, tbs, [noise] * MC_CELLS, gen)
        got = probe.process_ul_slot(first_reqs, samples_n)
        tried.append(round(noise, 5))
        for c in range(MC_CELLS):
            if levels[c] is None and not indications(got[c], "CrcIndication")[0].tb_crc_ok:
                levels[c], slot_a[c] = noise, samples_n[c]
    if any(lv is None for lv in levels):
        raise SystemExit(f"multi-cell HARQ: a first transmission decoded at every noise level "
                         f"{tried}")
    del probe
    slot_a = np.stack(slot_a)
    slot_b = mc_samples(again, tbs, levels, gen)
    # Cells 2-3 of the path-change slot send new data of another shape.
    other = [northstar_pdu(rnti=0x4601 + c, n_id=c + 1, rb_size=NS_PRB // 2, harq_id=6)
             for c in range(2, MC_CELLS)]
    other_tbs = [random_tb(pdu_tx_cfg(p, FAPI_SLOT), 1, gen) for p in other]
    slot_c = np.concatenate([slot_b[:2], mc_samples(other, other_tbs, [0.005] * 2, gen)])
    out = {"multi_cell_ul": launches}
    for name, pdus_b, samples_b, want in (
            ("in the batch", again, slot_b, tbs),
            ("moved to the per-cell path", again[:2] + other, slot_c, tbs[:2] + other_tbs)):
        phy = MultiCellUpperPhy(cell, MC_CELLS, device="cuda")
        failed = phy.process_ul_slot(first_reqs, slot_a)
        if any(indications(i, "CrcIndication")[0].tb_crc_ok for i in failed):
            raise SystemExit("multi-cell HARQ: a first transmission decoded")
        if [p.nof_reserved for p in phy.harq_pools] != [1] * MC_CELLS:
            raise SystemExit(f"multi-cell HARQ: reservations {[p.nof_reserved for p in phy.harq_pools]}")
        label = (f"multi-cell HARQ, retransmissions (rv {MC_RETX_RV}) {name}, each cell at "
                 f"its first failing noise level {[round(lv, 5) for lv in levels]}")
        inds, n = count_launches(lambda: phy.process_ul_slot(
            [UlTtiRequest(slot=FAPI_SLOT, pusch=(p,)) for p in pdus_b], samples_b), True, label)
        check_cells(inds, want, label)
        print(f"{label}: kernel launches {n}; reservations after the pass "
              f"{[p.nof_reserved for p in phy.harq_pools]}")
        out[f"multi_cell_harq_{'batch' if name == 'in the batch' else 'moved'}"] = n
    alone = UpperPhy(cell, device="cuda").process_ul_slot(
        UlTtiRequest(slot=FAPI_SLOT, pusch=(again[0],)), slot_b[0])
    alone_ok = indications(alone, "CrcIndication")[0].tb_crc_ok
    print(f"cell 0's retransmission alone, without the arena's history: tb_crc_ok {alone_ok}")
    if alone_ok:
        raise SystemExit("multi-cell HARQ: the retransmission decodes without its history")
    return out


def mc_dl_requests(csi_rs_last: bool = True):
    """Four cells' north-star DL slots, cell c's UE at rnti 0x4601 + c, n_id
    c + 1 and its SSB at sfn c; the last cell without CSI-RS unless
    `csi_rs_last`."""
    made = [dl_request(0x4601 + c, c + 1, seed=220 + c, sfn=c,
                       csi_rs=csi_rs_last or c < MC_CELLS - 1) for c in range(MC_CELLS)]
    return [m[0] for m in made], [m[1] for m in made]


def phase_multi_cell_dl(smi: str) -> None:
    """(22) `MultiCellUpperPhy.process_dl_slot`: four north-star DL slots of
    one structure as one batched call, against per-cell `process_dl_slot`
    on the card (bf16 grid bit for bit, samples to MC_DL_SAMPLES_REL_RMS),
    and with fetch=True as float32 real pairs equal to the call's tensors;
    then a set with the last cell's CSI-RS left out, which takes the
    per-cell fallback and must return the same real-pair layout."""
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    cell = dl_cell()
    mc = MultiCellUpperPhy(cell, MC_CELLS, device="cuda")
    one = UpperPhy(cell, device="cuda")
    nsamp = ofdm.slot_sample_count(NS_DFT, 1, DL_SLOT % 2)
    for name, reqs_datas in (("batched", mc_dl_requests()),
                             ("fallback (cell 3 without CSI-RS)", mc_dl_requests(False))):
        reqs, datas = reqs_datas
        grid, samples = mc.process_dl_slot(reqs, datas)
        torch.cuda.synchronize()
        shapes = (tuple(grid.shape), tuple(samples.shape))
        want = ((MC_CELLS, 4, 14, NS_PRB * 12, 2), (MC_CELLS, 4, nsamp, 2))
        grid_equal, rel = True, 0.0
        for c in range(MC_CELLS):
            g, s = one.process_dl_slot(reqs[c], datas[c], fetch=False)
            grid_equal = grid_equal and torch.equal(grid[c], g)
            rel = max(rel, float(((samples[c] - s).pow(2).mean() / s.pow(2).mean()).sqrt()))
        print(f"multi-cell DL, {MC_CELLS} north-star cells, {name}: grid {shapes[0]} "
              f"{grid.dtype}, samples {shapes[1]}; bf16 grid equal to per-cell dispatch: "
              f"{grid_equal}; samples relative RMS {rel:.3g} (bound {MC_DL_SAMPLES_REL_RMS}); "
              f"{smi}")
        if shapes != want or grid.dtype != torch.bfloat16 or not grid_equal \
                or not rel <= MC_DL_SAMPLES_REL_RMS:
            raise SystemExit(f"multi-cell DL {name}: differs from per-cell dispatch")
        # fetch=True: the same slots as float32 real pairs, through pinned staging.
        grid_h, samples_h = mc.process_dl_slot(reqs, datas, fetch=True)
        fetched_equal = (grid_h.dtype == samples_h.dtype == np.float32
                         and np.array_equal(grid_h, grid.float().cpu().numpy())
                         and np.array_equal(samples_h, samples.cpu().numpy()))
        print(f"multi-cell DL {name}, fetch=True: float32 pairs equal to the call's tensors: "
              f"{fetched_equal}")
        if not fetched_equal:
            raise SystemExit(f"multi-cell DL {name}: fetch=True differs from the device tensors")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded(gen) -> dict:
    """(23) The sharded paths in a one-rank NCCL group: `entry.dryrun_multichip(1)`
    (the port's `dryrun_multichip` of __graft_entry__.py:33-177: the
    north-star slot through `build_ulsch_tx_slot`, the identity FIR of
    `fir_filter_overlap_save`, `sharded_ofdm_demodulate` and
    `build_pusch_rx_from_grid` with early stop, then the codeblocks of one
    codeword through `build_sharded_ldpc_decode_es`), with the FIR's output
    equal to its input, the sharded demodulation within SHARD_RTOL/ATOL of
    `ops.ofdm.ofdm_demodulate` at DFT 4096, every TB bit back and the
    CB-sharded hard bits equal to the unsharded kernel's and to the info
    bits; `build_multi_cell_ulsch_tx` equal to the unsharded transmitter and
    `build_multi_cell_pusch_rx` decoding the FIR output; `entry.entry()` on
    a high-SNR slot of its own config (every TB passes) and on its noise
    example (none does); then 76 BG1 z=384
    codeblocks through `build_sharded_ldpc_decode_es` and
    `build_sharded_ldpc_decode`, bit for bit against the unsharded kernel."""
    import torch.distributed as dist

    from srsran_projectvtlmo_tpu_torch import entry
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import flatten_tb_bits
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.ops.crc import crc_host
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.decode_cuda import (
        ldpc_decode_cuda, ldpc_decode_es_cuda)
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.encode import ldpc_encode
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import BaseGraph
    from srsran_projectvtlmo_tpu_torch.parallel import (
        build_multi_cell_pusch_rx, build_multi_cell_ulsch_tx)
    from srsran_projectvtlmo_tpu_torch.parallel.cb_shard import (
        build_sharded_ldpc_decode, build_sharded_ldpc_decode_es)
    from srsran_projectvtlmo_tpu_torch.parallel.distributed import backend_for, make_ran_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(backend_for("cuda"), init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        rm = make_ran_mesh(1, 1, device="cuda")
        mesh = rm.mesh
        print(f"process group: {dist.get_backend()}, world {dist.get_world_size()}, mesh "
              f"{rm.nof_cells} cell x {rm.nof_sp} sp ({type(mesh).__name__})")
        label = f"entry.dryrun_multichip(1) (one {dist.get_backend()} rank)"
        res, rx_launches = count_launches(lambda: entry.dryrun_multichip(1), True, label)
        cfg, out = res["cfg"], res["rx"]
        fir_err = float((res["filtered"] - res["padded"]).abs().max())
        want = ofdm.ofdm_demodulate(res["samples"], cfg.nof_subc, NS_DFT, 1, 0)
        demod_err = float((res["grid"] - want).abs().max())
        demod_ok = bool(torch.allclose(res["grid"], want, rtol=SHARD_RTOL, atol=SHARD_ATOL))
        bits = flatten_tb_bits(out["tb_bits_cb"].cpu().numpy(), cfg.tbs)
        errors = int((bits != res["tb"].cpu().numpy()).sum())
        seg = cfg.segmentation
        unsharded = ldpc_decode_es_cuda(res["llrs"], seg.base_graph, seg.lifting_size, "CRC24B",
                                        22 * seg.lifting_size, nof_iterations=6)[0]
        cb_equal = bool(torch.equal(res["hard_cb"], unsharded))
        cb_info = bool((res["hard_cb"].cpu().numpy() == res["info_cb"]).all())
        print(f"{label}: tb_crc_ok {out['tb_crc_ok'].tolist()}, TB bit errors {errors}, "
              f"iterations max {int(out['ldpc_iterations'].max())}, early-stop launches "
              f"{rx_launches} (receiver and CB-sharded decode); identity FIR max |out - in| "
              f"{fir_err:.3g}; sharded demod max |err| {demod_err:.3g} (rtol {SHARD_RTOL}, atol "
              f"{SHARD_ATOL}); {res['llrs'].shape[0]} CB-sharded codeblocks: equal to the "
              f"unsharded kernel {cb_equal}, hard bits == info {cb_info}")
        if not (bool(out["tb_crc_ok"].all()) and errors == 0 and fir_err == 0.0 and demod_ok
                and cb_equal and cb_info):
            raise SystemExit(f"{label}: the sharded lower PHY or a decode failed")

        # The cell-axis builders on the same slot: the transmitter equal to
        # the unsharded one, the receiver on the FIR output.
        tb = res["tb"]
        layers, _ = build_multi_cell_ulsch_tx(cfg, mesh, device="cuda")(tb)
        tx_equal = bool(torch.equal(layers, build_ulsch_tx_slot(cfg, "cuda")(tb)[0]))
        rx = build_multi_cell_pusch_rx(cfg, mesh, device="cuda")
        filt = res["filtered"][..., :res["samples"].shape[-2], :]
        label = f"multi_cell rx over the FIR output (one {dist.get_backend()} rank)"
        mc_out, mc_launches = count_launches(lambda: rx(filt), True, label)
        bits = flatten_tb_bits(mc_out["tb_bits_cb"].cpu().numpy(), cfg.tbs)
        mc_errors = int((bits != tb.cpu().numpy()).sum())
        print(f"{label}: multi_cell Tx equal to the unsharded Tx {tx_equal}, tb_crc_ok "
              f"{mc_out['tb_crc_ok'].tolist()}, TB bit errors {mc_errors}, kernel launches "
              f"{mc_launches}")
        if not (tx_equal and bool(mc_out["tb_crc_ok"].all()) and mc_errors == 0):
            raise SystemExit(f"{label}: the cell-axis builders failed")

        fn, (noise,) = entry.entry()
        ecfg = entry.entry_config()
        tb_e = random_tb(ecfg, noise.shape[0], gen)
        _, tx_samples = build_ulsch_tx_slot(ecfg, "cuda")(tb_e)  # (B, nsamples, 2)
        clean = tx_samples[:, None] + 1e-3 * torch.randn(tx_samples[:, None].shape,
                                                         generator=gen, device="cuda")
        label = "entry.entry() (24 PRB QAM16 R=0.5, 1 port, batch 2)"
        (ok, snr), entry_launches = count_launches(lambda: fn(clean), True, label)
        ok_noise, snr_noise = fn(noise)
        print(f"{label}: high-SNR slot tb_crc_ok {ok.tolist()}, snr_db "
              f"{[round(v, 2) for v in snr.tolist()]}, kernel launches {entry_launches}; its "
              f"noise example tb_crc_ok {ok_noise.tolist()}, snr_db "
              f"{[round(v, 2) for v in snr_noise.tolist()]}")
        if not (bool(ok.all()) and not bool(ok_noise.any())
                and bool(torch.isfinite(snr).all() and torch.isfinite(snr_noise).all())):
            raise SystemExit(f"{label}: the entry step did not decode its high-SNR slot")

        seg = cfg.segmentation
        z, k = seg.lifting_size, 22 * seg.lifting_size
        rng = np.random.default_rng(23)
        payload = rng.integers(0, 2, (seg.nof_cb, k - 24)).astype(np.uint8)
        info = np.concatenate([payload, np.stack([crc_host(p, "CRC24B") for p in payload])], -1)
        cw = ldpc_encode(torch.as_tensor(info, device="cuda"), BaseGraph.BG1, z)[:, 2 * z:]
        base = (1 - 2 * cw.to(torch.int32)) * 8
        flip = torch.rand(base.shape, generator=gen, device="cuda") < 0.05
        llr = torch.where(flip, -base // 2, base).to(torch.int8).contiguous()
        launches = {}
        for name, sharded, plain in (
                ("ldpc_decode_es",
                 build_sharded_ldpc_decode_es(mesh, BaseGraph.BG1, z, "CRC24B", k, 6, axis="sp"),
                 lambda: ldpc_decode_es_cuda(llr, BaseGraph.BG1, z, "CRC24B", k,
                                             nof_iterations=6)),
                ("ldpc_decode", build_sharded_ldpc_decode(mesh, BaseGraph.BG1, z, 6, axis="sp"),
                 lambda: ldpc_decode_cuda(llr, BaseGraph.BG1, z, nof_iterations=6))):
            label = f"CB-sharded {name}, {seg.nof_cb} BG1 z={z} codeblocks, axis sp"
            got, launches[name] = count_launches(lambda: sharded(llr), name == "ldpc_decode_es",
                                                 label)
            want = plain()
            equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            hard_ok = bool(torch.equal(got[0].cpu(), torch.as_tensor(info)))
            print(f"{label}: outputs equal to the unsharded kernel {equal}, hard bits == info "
                  f"{hard_ok}, kernel launches {launches[name]}" +
                  (f", iterations max {int(got[3].max())}" if len(got) == 4 else ""))
            if not (all(equal) and hard_ok):
                raise SystemExit(f"{label}: differs from the unsharded kernel")
    finally:
        dist.destroy_process_group()
    return {"dryrun_multichip": rx_launches, "multi_cell_rx": mc_launches,
            "entry": entry_launches, "sharded_es": launches["ldpc_decode_es"],
            "sharded_fixed": launches["ldpc_decode"]}


# ------------------------------------------------- the app and the fronthaul --

#: The app phase: slots of the north-star profile (one TDD period of 8: the
#: SSB at slot 0, the PRACH occasion at slot 4), the slots whose host time is
#: reported (0 and 1 build the receivers and plans), and the early-stop
#: launches of one north-star PUSCH PDU (PERF.md section 6).
APP_SLOTS, APP_TIMED, ES_PER_PDU = 8, range(2, 8), 2
#: The fronthaul phase: BFP width and linear backoff of the DL loop
#: (tests/test_ofh_loop.py), the bound on each port's EVM through it, and the
#: U-plane frame dropped to check loss detection (port 0, symbol 5).
OFH_WIDTH, OFH_SCALING, OFH_EVM = 9, 0.5, 0.01
VLAN_TCI = 3


def run_app(argv: list[str], label: str) -> tuple[int, str, dict]:
    """apps.gnb_sim.main(argv) in this process with the launch counts set to 0
    just before and read just after: (exit code, its standard output, the
    launches).  The output is printed as well."""
    import contextlib
    import io

    from srsran_projectvtlmo_tpu_torch.apps import gnb_sim
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode_cuda

    out = io.StringIO()
    decode_cuda.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = gnb_sim.main(argv)
    torch.cuda.synchronize()
    launches = dict(decode_cuda.LAUNCHES)
    text = out.getvalue()
    print(f"{label}: gnb_sim.main({argv}) -> {rc}, kernel launches {launches}")
    print(text.strip())
    return rc, text, launches


def trace_spans(path: str) -> dict:
    """{span name: [(begin us, end us), ...] in order} of the app's
    torch.profiler Chrome trace (`--trace`): its host spans."""
    events = json.load(open(path))["traceEvents"]
    spans: dict = {}
    for e in sorted((e for e in events if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return spans


def phase_app(smi: str) -> dict:
    """(25) The port's app on the card: `apps.gnb_sim.main(["--northstar",
    "--slots", "8"])` in this process, traced: every PUSCH CRC, PUCCH F1 and
    the PRACH must pass and every DL slot drain from the pipeline, with
    ES_PER_PDU early-stop launches per PUSCH PDU and no fixed-mode launch;
    one JSON line with the host ms per DL+UL slot pair over slots 2-7 (the
    trace's k-th app.dl_slot begin to k-th app.ul_slot end, under the
    profiler).  Then the default profile, streaming, traced and recording
    its DL IQ: exit 0, two app.dl_slot and two app.ul_slot spans with the
    port's entry spans inside, and the IQ file read back by `FileIqSource`
    equal to the samples sent."""
    import re
    import tempfile

    from srsran_projectvtlmo_tpu_torch.apps import gnb_sim
    from srsran_projectvtlmo_tpu_torch.radio import FileIqSink, FileIqSource

    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "northstar.json")
        label = f"app --northstar, {APP_SLOTS} slots"
        rc, text, launches = run_app(["--northstar", "--slots", str(APP_SLOTS), "--trace", trace],
                                     label)
        m = re.search(r"UL CRC OK (\d+)/(\d+), PUCCH F1 (\d+)/(\d+), PRACH (\d+)/(\d+), "
                      r"DL pipelined (\d+)/(\d+), late (\d+)", text)
        counts = [int(g) for g in m.groups()] if m else None
        want = [APP_SLOTS] * 4 + [1, 1] + [APP_SLOTS] * 2
        es_want = ES_PER_PDU * APP_SLOTS
        if not (rc == 0 and counts is not None and counts[:8] == want
                and launches["ldpc_decode_es"] == es_want and launches["ldpc_decode"] == 0):
            raise SystemExit(f"{label}: exit {rc}, counts {counts} (want {want} and late), "
                             f"launches {launches} (want {es_want} early-stop, 0 fixed)")
        spans = trace_spans(trace)
        pair_ms = [(spans["app.ul_slot"][k][1] - spans["app.dl_slot"][k][0]) / 1e3
                   for k in APP_TIMED]
        metric_line("app_northstar_host_ms_per_dl_ul_slot_pair", float(np.median(pair_ms)), "ms",
                    min=min(pair_ms), max=max(pair_ms), per_slot=pair_ms,
                    slots=f"{APP_TIMED.start}-{APP_TIMED.stop - 1} of {APP_SLOTS}",
                    late=counts[8], ldpc_decode_es_launches=launches["ldpc_decode_es"],
                    note="profiler clock (app spans, traced), DL pipelined unsynced, UL synced "
                         "on its indications", card=smi)

        trace = os.path.join(tmp, "default.json")
        iq = os.path.join(tmp, "dl.iq")
        sent = []

        class RecordingSink(FileIqSink):
            def transmit(self, samples_pair):
                sent.append(np.array(samples_pair, np.float32))
                super().transmit(samples_pair)

        gnb_sim.FileIqSink = RecordingSink
        try:
            label = "app default profile, 2 slots, streaming"
            rc, text, default_launches = run_app(
                ["--slots", "2", "--streaming", "--trace", trace, "--iq-out", iq], label)
        finally:
            gnb_sim.FileIqSink = FileIqSink
        spans = trace_spans(trace)
        names = {k: len(v) for k, v in spans.items()
                 if k.startswith("app.") or k.endswith("process_dl_slot")
                 or k.endswith("process_ul_slot")}
        want_iq = np.concatenate([s.reshape(-1, 2) for s in sent]) if sent else None
        got_iq = FileIqSource(iq).receive(len(want_iq))[0] if sent else None
        iq_ok = sent and os.path.getsize(iq) == want_iq.nbytes and np.array_equal(got_iq, want_iq)
        print(f"{label}: trace spans {names}, DL IQ {len(sent)} slots, "
              f"{os.path.getsize(iq)} bytes, read back equal {bool(iq_ok)}")
        want_names = {"app.dl_slot": 2, "app.ul_slot": 2, "upper_phy.process_dl_slot": 2}
        if not (rc == 0 and "UL CRC OK 2/2" in text
                and all(names.get(k) == n for k, n in want_names.items()) and iq_ok
                and default_launches["ldpc_decode_es"] > 0
                and default_launches["ldpc_decode"] == 0):
            raise SystemExit(f"{label}: exit {rc}, spans {names}, IQ equal {bool(iq_ok)}, "
                             f"launches {default_launches}")
    return {"app_northstar": launches["ldpc_decode_es"],
            "app_default": default_launches["ldpc_decode_es"]}


def du_frames(wire: np.ndarray, slot_count: int) -> list[tuple[str, int, bytes]]:
    """DU side of the split-7.2 fronthaul: one C-plane type-1 message per
    port, then per port and symbol one U-plane message of the packed PRBs
    (P, 14, nprb, bytes per PRB), each in eCPRI in a VLAN frame with the
    port's eAxC as pc_id and a per-eAxC sequence id: [(kind, port, frame)]."""
    from srsran_projectvtlmo_tpu_torch.ofh import cplane, ecpri, ethernet, uplane
    from srsran_projectvtlmo_tpu_torch.ran.slot import SlotPoint

    vlan = ethernet.VlanFrameParams(mac_dst=b"\x02\x00\x00\x00\x00\x01",
                                    mac_src=b"\x02\x00\x00\x00\x00\x02", tci=VLAN_TCI)
    pt = SlotPoint(numerology=1, count=slot_count)
    nports, nsym, nprb = wire.shape[:3]
    frames = []
    for p in range(nports):
        eaxc = ethernet.eaxc_pc_id(0, 0, 0, p)
        hdr = cplane.CplaneRadioHeader(direction=1, sfn=pt.sfn, subframe=pt.subframe_index,
                                       slot=pt.slot_in_subframe, start_symbol=0)
        sec = cplane.CplaneCommonSection(section_id=0, prb_start=0, nof_prb=nprb, nof_symbols=nsym)
        msg = cplane.build_type1_message(hdr, sec)
        frames.append(("cplane", p, ethernet.build_vlan_frame(
            vlan, ecpri.build_rt_control_packet(eaxc, 0, msg))))
        for s in range(nsym):
            params = uplane.UplaneMessageParams(slot=pt, symbol_id=s, start_prb=0, nof_prb=nprb,
                                                data_width=OFH_WIDTH)
            pkt = ecpri.build_iq_data_packet(eaxc, s & 0xFF,
                                             uplane.build_uplane_message(params, wire[p, s]))
            frames.append(("uplane", p, ethernet.build_vlan_frame(vlan, pkt)))
    return frames


def ru_receive(frames, nports: int, nprb: int) -> tuple[np.ndarray, int, int]:
    """RU side: every frame back through VLAN, eCPRI, the per-eAxC
    sequence-id checker, the U-plane decoder and the rx-window checker:
    (packed PRBs (P, 14, nprb, bytes per PRB), lost frames, C-plane messages)."""
    from srsran_projectvtlmo_tpu_torch.ofh import cplane, ecpri, ethernet, uplane
    from srsran_projectvtlmo_tpu_torch.ofh.reception import RxWindowChecker, SequenceIdChecker

    seq = SequenceIdChecker()
    win = RxWindowChecker(numerology=1, sym_start=0, sym_end=28)
    per_prb = 1 + (24 * OFH_WIDTH + 7) // 8
    wire = np.zeros((nports, 14, nprb, per_prb), np.uint8)
    lost = ncplane = 0
    for kind, _, frame in frames:
        pkt = ecpri.decode_packet(ethernet.decode_vlan_frame(frame).payload)
        if kind == "cplane":
            # numPrb 0 encodes "all PRBs" for a carrier wider than 255 PRB.
            ncplane += cplane.decode_message(pkt.payload).section.nof_prb == \
                (nprb if nprb <= 255 else 0)
            continue
        lost += abs(seq.update_and_compare(pkt.pc_id, pkt.seq_id))
        res = uplane.decode_uplane_message(pkt.payload, static_width=OFH_WIDTH)
        slot_index = res.slot_id + 2 * res.subframe_id
        win.on_new_symbol(res.frame_id, slot_index, res.symbol_id)
        if win.check(res.frame_id, slot_index, res.symbol_id) != "on_time":
            raise SystemExit("fronthaul: a U-plane message fell outside the rx window")
        wire[ethernet.eaxc_unpack(pkt.pc_id)[3], res.symbol_id,
             res.start_prb:res.start_prb + res.nof_prb] = res.prb_payload
    return wire, lost, ncplane


def phase_fronthaul(dl_phy, dl_req, dl_data, gen, smi: str) -> dict:
    """(26) The north-star DL slot of phase 18 (273 PRB x 4 ports, bf16 grid)
    through the port's split-7.2 fronthaul on the card: `bfp_compress` +
    `pack_prbs` of the whole slot at OFH_WIDTH bits with OFH_SCALING backoff,
    U-plane / C-plane / eCPRI / VLAN framing on the host, back through the
    sequence-id and rx-window checkers, `unpack_prbs` + `bfp_decompress` on
    the card; each port's EVM below OFH_EVM, no frame lost, and one dropped
    frame detected.  One JSON line: the device ms of one batched compress +
    pack of the slot (CUDA events) and the host ms of framing and deframing.
    Then `LowerPhy`: a north-star UL slot's samples into a `LoopbackGateway`,
    `run_ul_slot` decoding the PUSCH (CRC and TB bits, ES_PER_PDU early-stop
    launches), and `run_dl_slot` on the DL slot with its amplitude metrics.
    Last, the native host library is built and in use."""
    from srsran_projectvtlmo_tpu_torch import native
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import UlTtiRequest
    from srsran_projectvtlmo_tpu_torch.ops.ofdm import slot_sample_count
    from srsran_projectvtlmo_tpu_torch.ops.ofh_compression import (
        bfp_compress, bfp_decompress, pack_prbs, unpack_prbs)
    from srsran_projectvtlmo_tpu_torch.phy.lower import LowerPhy
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import ExpertPhyConfig, UpperPhy
    from srsran_projectvtlmo_tpu_torch.radio import LoopbackGateway
    from srsran_projectvtlmo_tpu_torch.utils.cplx import to_cplx

    grid_pair, _ = dl_phy.process_dl_slot(dl_req, dl_data, fetch=False)  # (4, 14, S, 2) bf16
    nports, nprb = grid_pair.shape[0], grid_pair.shape[2] // 12
    re_pair = grid_pair.float().reshape(nports, 14, nprb, 12, 2)

    def compress():
        mant, exp = bfp_compress(re_pair, OFH_WIDTH, OFH_SCALING)
        return pack_prbs(mant, OFH_WIDTH, exp)

    compress_ms = cuda_time_ms(compress, reps=20)
    wire = compress().cpu().numpy()
    t0 = time.perf_counter()
    frames = du_frames(wire, DL_SLOT)
    t1 = time.perf_counter()
    got, lost, ncplane = ru_receive(frames, nports, nprb)
    t2 = time.perf_counter()
    mant, exp = unpack_prbs(torch.as_tensor(got, device="cuda"), OFH_WIDTH)
    rebuilt = to_cplx(bfp_decompress(mant, OFH_WIDTH, OFH_SCALING, exponents=exp))
    ref = to_cplx(re_pair)
    evm = ((rebuilt - ref).abs().pow(2).sum((1, 2, 3)).sqrt()
           / ref.abs().pow(2).sum((1, 2, 3)).sqrt()).tolist()
    dropped = [f for i, f in enumerate(frames) if i != 6]  # port 0, symbol 5
    _, lost_dropped, _ = ru_receive(dropped, nports, nprb)
    print(f"fronthaul: north-star DL slot, {nports} ports x 14 symbols x {nprb} PRB, BFP "
          f"{OFH_WIDTH} bit, {len(frames)} VLAN frames ({ncplane} C-plane), "
          f"{sum(len(f) for _, _, f in frames)} bytes; EVM per port "
          f"{[round(e, 5) for e in evm]} (bound {OFH_EVM}); lost {lost}; with one U-plane frame "
          f"dropped: lost {lost_dropped}")
    if not (max(evm) < OFH_EVM and lost == 0 and lost_dropped >= 1 and ncplane == nports):
        raise SystemExit("fronthaul: the DL slot did not come back through the fronthaul")
    metric_line("ofh_bfp_compress_pack_ms_per_slot", compress_ms, "ms",
                prbs=nports * 14 * nprb, width=OFH_WIDTH,
                bytes_in=re_pair.numel() * 4, bytes_out=int(wire.size),
                host_framing_ms=(t1 - t0) * 1e3, host_deframing_ms=(t2 - t1) * 1e3,
                frames=len(frames), note="device ms: CUDA events, mean of 20 back-to-back "
                "bfp_compress + pack_prbs of the whole slot; framing on the host clock", card=smi)

    phy = UpperPhy(fapi_cell(), ExpertPhyConfig(pusch_decoder_max_iterations=6), device="cuda")
    gw = LoopbackGateway(nof_ports=4)
    lower = LowerPhy(phy, gw)
    pdu = northstar_pdu()
    tb = random_tb(pdu_tx_cfg(pdu, FAPI_SLOT), 1, gen)
    carrier = torch.zeros((4, 14, NS_PRB * 12), dtype=torch.complex64, device="cuda")
    add_pusch(carrier, pdu, pusch_layers(pdu, FAPI_SLOT, tb))
    samples = carrier_samples(carrier, 0.005, gen)
    nsamp = slot_sample_count(NS_DFT, 1, FAPI_SLOT % 2)
    request = UlTtiRequest(slot=FAPI_SLOT, pusch=(pdu,))
    gw.transmit(samples)
    lower.run_ul_slot(request, nsamp)  # builds the receiver
    gw.transmit(samples)
    label = "LowerPhy.run_ul_slot (LoopbackGateway, north-star PUSCH)"
    inds, ul_launches = count_launches(lambda: lower.run_ul_slot(request, nsamp), True, label)
    check_pusch(inds, tb, label + f", kernel launches {ul_launches}")
    if ul_launches != ES_PER_PDU:
        raise SystemExit(f"{label}: {ul_launches} early-stop launches, not {ES_PER_PDU}")
    metrics = LowerPhy(dl_phy, gw).run_dl_slot(dl_req, dl_data)
    out = gw.receive(slot_sample_count(NS_DFT, 1, DL_SLOT % 2))
    print(f"LowerPhy.run_dl_slot (north-star DL slot): avg power {metrics.avg_power:.4g}, peak "
          f"{metrics.peak_power:.4g}, PAPR {metrics.papr_db:.2f} dB, clipped "
          f"{metrics.clipped_ratio:.3g}; gateway samples {out.shape}, finite "
          f"{bool(np.isfinite(out).all())}")
    if not (np.isfinite(out).all() and metrics.avg_power > 0):
        raise SystemExit("LowerPhy.run_dl_slot: no samples reached the gateway")

    t0 = time.perf_counter()
    lib_ok = native.available()
    print(f"native host library: in use {lib_ok} ({native.library_path().name}, "
          f"{time.perf_counter() - t0:.2f} s to build and load)")
    if not lib_ok:
        raise SystemExit("native host library did not build: the Python fallback would run")
    return {"lower_phy_ul": ul_launches}


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
    fapi = {**phase_fapi_northstar(gen, smi), **phase_fapi_harq(gen),
            **phase_fapi_mixed(gen, smi)}
    dl_phy, dl_req, dl_data = phase_dl_northstar(smi)
    fapi.update(phase_dl_loopback())
    print(json.dumps({"fapi_ldpc_decode_es_launches_per_call": fapi}))
    scaling = phase_multi_cell_ul(gen)
    phase_multi_cell_dl(smi)
    scaling.update(phase_sharded(gen))
    print(json.dumps({"scaling_launches_per_call": scaling}))
    host_paths = {**phase_app(smi), **phase_fronthaul(dl_phy, dl_req, dl_data, gen, smi)}
    print(json.dumps({"app_and_lower_phy_launches_per_call": host_paths}))
    # The kernels' rows count the main path's launches and those of the
    # multi-cell, sharded, app and lower-PHY calls.
    es_launches += sum(n for k, n in scaling.items() if k != "sharded_fixed")
    es_launches += sum(host_paths.values())
    fx_launches += scaling["sharded_fixed"]

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
