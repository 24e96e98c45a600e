"""Entry points of the port: a one-device forward step of the flagship PUSCH
receiver and the multi-device dry run (the counterparts of the repo's
`__graft_entry__.py` for the JAX package).

    python -m srsran_projectvtlmo_tpu_torch.entry

runs `entry()` once on the card.  Both functions default to the card; the
CPU tests pass device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from .models.pusch_rx import PuschRxConfig, build_pusch_rx_from_grid, build_pusch_rx_slot
from .models.ulsch_tx import build_ulsch_tx_slot
from .ops.ldpc.encode import ldpc_encode
from .ops.ofdm import ofdm_modulate, slot_sample_count
from .ops.precoding import precode
from .parallel.cb_shard import build_sharded_ldpc_decode_es
from .parallel.distributed import make_ran_mesh, maybe_initialize_distributed
from .parallel.mesh import gather_tree, shard_leading
from .parallel.sample_shard import fir_filter_overlap_save, shard_samples, sharded_ofdm_demodulate
from .ran.modulation import Modulation
from .utils.tables import resolve_device

#: The dry run's carrier: the north-star cell (273 PRB, DFT 4096 at 30 kHz).
NS_PRB, NS_DFT = 273, 4096


def entry_config() -> PuschRxConfig:
    """The entry's receiver: 24 PRB, QAM16 R=0.5, 1 rx port, DFT 512, mu 1."""
    return PuschRxConfig(nof_rb=24, modulation=Modulation.QAM16, target_code_rate=0.5,
                         nof_rx_ports=1, dft_size=512, numerology=1)


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship PUSCH receiver.
    fn(samples (B, 1, nsamples, 2)) -> (tb_crc_ok (B,), snr_db (B,)); the
    example is a batch of 2 slots of Gaussian noise made from seed 0."""
    dev = resolve_device(device)
    cfg = entry_config()
    rx = build_pusch_rx_slot(cfg, dev)
    nsamp = slot_sample_count(cfg.dft_size, cfg.numerology, 0)
    rng = np.random.default_rng(0)
    samples = torch.as_tensor(rng.normal(size=(2, 1, nsamp, 2)).astype(np.float32), device=dev)

    def fn(s):
        out = rx(s)
        return out["tb_crc_ok"], out["snr_db"]

    return fn, (samples,)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the full slot step once over an n-device (cell x sp) mesh.

    The north-star workload per cell -- 273 PRB, QAM256 R=948/1024, 2
    layers, 4 rx ports (BASELINE.md config 5) -- with cells on the "cell"
    axis and the baseband sample axis sharded over "sp" with overlap-save
    halo exchange; then the codeblock axis of one codeword over "sp" through
    the early-stop decoder, and with two cell shards the batched multi-cell
    DL.  `n_devices` is the world size: 1 runs in one process (with or
    without a one-rank process group), more need a process group of that
    many ranks (`parallel.distributed`).  Raises when a decode fails.

    Returns what it computed, for callers that check further: the config,
    the TB bits, the slot samples before and after the sample-axis padding,
    the FIR output, the sharded-demodulated grid, the receiver's result, and
    the codeblock case (info bits, LLRs, decoded hard bits).
    """
    dev = resolve_device(device)
    maybe_initialize_distributed(device)  # no-op in one process; torchrun's env otherwise
    n_cell = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    rmesh = make_ran_mesh(nof_cell_shards=n_cell, nof_sp_shards=n_devices // n_cell,
                          device=device)
    mesh, n_sp = rmesh.mesh, rmesh.nof_sp

    nports, nlayers = 4, 2
    cfg = PuschRxConfig(
        nof_rb=NS_PRB, modulation=Modulation.QAM256, target_code_rate=948 / 1024,
        nof_rx_ports=nports, nof_layers=nlayers, dft_size=NS_DFT, numerology=1,
        # The production decoder path: CRC-gated early stop, as the app runs.
        ldpc_early_stop=True, nof_ldpc_iterations=6)
    tx = build_ulsch_tx_slot(cfg, dev)
    rx = build_pusch_rx_from_grid(cfg, dev)

    rng = np.random.default_rng(0)
    tb = torch.as_tensor(rng.integers(0, 2, (n_cell, cfg.tbs)).astype(np.uint8), device=dev)
    # Well-conditioned constant 4x2 mixing channel (unitary columns).
    w = np.exp(-2j * np.pi * np.outer(np.arange(nports), np.arange(nlayers))
               / nports) / np.sqrt(nports)
    w_pair = torch.as_tensor(np.stack([w.real, w.imag], -1).astype(np.float32), device=dev)

    grid_tx, _ = tx(tb)  # (n_cell, L, 14, nsubc, 2) layer grids, every cell on every rank
    g = grid_tx.reshape(n_cell, nlayers, -1, 2)
    rx_grid = precode(g, w_pair).reshape(n_cell, nports, 14, cfg.nof_subc, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = 1e-3 * torch.randn(rx_grid.shape, generator=gen, device=dev)
    samples = ofdm_modulate(rx_grid + noise, cfg.dft_size, cfg.numerology, 0)
    # Lower PHY on the sequence axis: identity-passband FIR with overlap-save
    # halo exchange, then the sample-sharded OFDM demodulation.
    padded = shard_samples(samples, mesh, "sp", batch_axis="cell")
    taps = np.zeros(5, np.float32)
    taps[0] = 1.0
    filt = fir_filter_overlap_save(padded, taps, mesh, "sp", batch_axis="cell")
    grid = sharded_ofdm_demodulate(filt, cfg.nof_subc, cfg.dft_size, cfg.numerology, mesh,
                                   axis="sp", batch_axis="cell")  # (n_cell, P, 14, nsubc, 2)
    out = gather_tree(rx(shard_leading(grid, mesh, "cell")), mesh, "cell")
    ok = out["tb_crc_ok"].cpu().numpy()
    if ok.shape != (n_cell,) or not ok.all():
        raise RuntimeError(f"multichip dry run decode failed: {ok}")

    # Codeblock-axis sharding (SURVEY Section 2.4 item 1): one codeword's CBs
    # decode across the "sp" axis through the production early-stop decoder.
    seg = cfg.segmentation
    zz = seg.lifting_size
    ncb = -(-seg.nof_cb // n_sp) * n_sp
    info_cb = rng.integers(0, 2, (ncb, 22 * zz)).astype(np.uint8)
    cw = ldpc_encode(torch.as_tensor(info_cb, device=dev), seg.base_graph, zz)
    llrs = ((1 - 2 * cw[:, 2 * zz:].to(torch.int32)) * 8).to(torch.int8).contiguous()
    dec_cb = build_sharded_ldpc_decode_es(mesh, seg.base_graph, zz, "CRC24B", 22 * zz, 6,
                                          axis="sp")
    hard_cb = dec_cb(llrs)[0]
    if not np.array_equal(hard_cb.cpu().numpy(), info_cb):
        raise RuntimeError("CB-sharded decode failed")

    # Batched multi-cell DL: every cell's slot assembly as one call over the
    # "cell" axis (parallel.multi_cell_phy.process_dl_slot).
    if n_cell > 1:
        _dryrun_multi_cell_dl(rmesh, n_cell, rng, device)

    print(f"dryrun_multichip: {n_devices} devices as ({n_cell} cell x {n_sp} sp)"
          f" mesh; north-star slot ({NS_PRB} PRB QAM256 2-layer 4-port,"
          f" TBS={cfg.tbs}) decoded OK per cell through the halo-exchange"
          f" lower PHY with the CRC-gated early-stop decoder"
          f" (iters used: {int(out['ldpc_iterations'].max())});"
          f" CB-axis sharded ES decode over {n_sp} 'sp' chips OK;"
          f" batched multi-cell DL assembly over the cell axis OK", flush=True)
    return {"cfg": cfg, "tb": tb, "samples": samples, "padded": padded, "filtered": filt,
            "grid": grid, "rx": out, "info_cb": info_cb, "llrs": llrs, "hard_cb": hard_cb}


def _dryrun_multi_cell_dl(rmesh, n_cell: int, rng, device) -> None:
    from .fapi.pdus import DlTtiRequest, PdschPdu, SsbPdu, TxDataRequest
    from .parallel.multi_cell_phy import MultiCellUpperPhy
    from .phy.dl_slot import get_dl_slot_program
    from .phy.upper_phy import CellConfig

    dl_cell = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_tx_ports=2, phys_cell_id=1)
    mc = MultiCellUpperPhy(dl_cell, n_cell, ran_mesh=rmesh, device=device)
    reqs, txs = [], []
    for c in range(n_cell):
        req = DlTtiRequest(
            slot=2,
            ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=c, half_radio_frame=False),),
            pdsch=(PdschPdu(rnti=0x4601 + c, rb_start=0, rb_size=12,
                            modulation=Modulation.QAM16, target_code_rate=0.5, nof_layers=2,
                            start_symbol=2, nof_symbols=10, dmrs_symbols=(2,), n_id=c),))
        tbs_dl = get_dl_slot_program(req, dl_cell, device).pdsch_cfgs[0].tbs
        reqs.append(req)
        txs.append(TxDataRequest(slot=2, tb_bits=[rng.integers(0, 2, tbs_dl).astype(np.uint8)]))
    grids, _ = mc.process_dl_slot(reqs, txs)
    if grids.shape[0] != n_cell:
        raise RuntimeError(f"multi-cell DL returned {grids.shape[0]} cells, not {n_cell}")


if __name__ == "__main__":
    fn, args = entry()
    print("entry:", fn(*args))
