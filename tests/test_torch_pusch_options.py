"""PyTorch port, the receiver's options against the JAX package: the ZF and
per-RE equalizers, and whole slots with `equalizer="zf"`, DM-RS type 2,
intra-slot frequency hopping and `dynamic_params` (several UEs with their
own rnti and n_id in one call).

Slots are made by the JAX transmitter at 12 PRB, DFT 256, 30 kHz, mixed onto
the rx ports with noise (`tests/test_torch_pusch_uci._samples`), and the same
samples or grids go through both receivers.

Tolerances and why:
  * weights, equalized symbols and noise variances: rtol 1e-4, atol 1e-5 of
    the values' scale (float32 elementwise forms or small complex inverses
    in another summation order), as the MMSE tests of
    tests/test_torch_rx_stages.py; against the reference C++ vectors 2e-3,
    the JAX package's own bound.
  * slot outputs: as `tests/test_torch_pusch_rx._compare`, and UCI as
    `tests/test_torch_pusch_uci.compare_uci`.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models.pusch_rx import build_pusch_rx_from_grid as jax_from_grid
from srsran_projectvtlmo_tpu.models.pusch_rx import build_pusch_rx_slot as jax_rx_slot
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot as jax_tx_slot
from srsran_projectvtlmo_tpu.ops import equalization as jax_eq

from srsran_projectvtlmo_tpu_torch.models.pusch_rx import (
    build_pusch_rx_from_grid, build_pusch_rx_slot, flatten_tb_bits)
from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu_torch.ops import equalization
from srsran_projectvtlmo_tpu_torch.utils.cplx import np_to_pair
from tests.test_torch_pusch_rx import _compare
from tests.test_torch_pusch_uci import (
    _configs, _payloads, _samples, compare_uci, dynamic_inputs)

T = torch.as_tensor
VECTORS = Path(__file__).parent / "vectors"


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol * max(float(np.abs(want[np.isfinite(want)]).max()), 1.0))


# ----------------------------------------------------------- equalizers --

@pytest.mark.parametrize("nports,nlayers", [(4, 1), (2, 2), (4, 2), (4, 3)])
def test_zf_weights_and_apply_weights_match_jax(nports, nlayers):
    rng = np.random.default_rng(nports * 10 + nlayers)
    s = 48
    h = rng.normal(size=(2, s, nports, nlayers, 2)).astype(np.float32) * 0.5
    h[..., np.arange(nlayers), np.arange(nlayers), 0] += 3.0  # well conditioned
    if nlayers <= 2:
        h[0, 0] = 0.0  # a dead subcarrier: zero weights, infinite noise
    nv = rng.uniform(0.01, 0.1, (2, nports)).astype(np.float32)
    w_j, nv_j = jax.jit(jax_eq.zf_weights)(jnp.asarray(h), jnp.asarray(nv))
    w_t, nv_t = equalization.zf_weights(T(h), T(nv))
    assert w_t.shape == w_j.shape and nv_t.shape == nv_j.shape
    _close(w_t, w_j)
    _close(nv_t, nv_j)
    y = rng.normal(size=(2, 5, s, nports, 2)).astype(np.float32)
    w_j = np.array(w_j)  # both apply the same weights
    _close(equalization.apply_weights(T(w_j), T(y)),
           jax.jit(jax_eq.apply_weights)(jnp.asarray(w_j), jnp.asarray(y)), rtol=1e-5, atol=1e-6)


def test_per_re_equalizers_match_jax():
    """`equalize_mmse_1xn`, `equalize_zf_1xn` (one layer) and
    `equalize_mmse_general` (2 layers) over 4 ports, with a degenerate RE."""
    nports = 4
    rng = np.random.default_rng(nports)
    nre = 30
    y = rng.normal(size=(2, nre, nports, 2)).astype(np.float32)
    h1 = rng.normal(size=(2, nre, nports, 2)).astype(np.float32)
    h1[1, 3] = 0.0
    nv = rng.uniform(0.01, 0.2, (2, nports)).astype(np.float32)
    for fn in ("equalize_mmse_1xn", "equalize_zf_1xn"):
        got = getattr(equalization, fn)(T(y), T(h1), T(nv), 0.8)
        want = jax.jit(getattr(jax_eq, fn), static_argnums=3)(
            jnp.asarray(y), jnp.asarray(h1), jnp.asarray(nv), 0.8)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            _close(a, b)
    h = rng.normal(size=(2, nre, nports, 2, 2)).astype(np.float32)
    got = equalization.equalize_mmse_general(T(y), T(h), T(nv))
    want = jax.jit(jax_eq.equalize_mmse_general)(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    for a, b in zip(got, want):
        _close(a, b)


with np.load(VECTORS / "eq_reference.npz") as _z:
    _EQ = {k: _z[k] for k in _z.files}


@pytest.mark.parametrize("key", sorted({k.rsplit("_", 1)[0] for k in _EQ}))
def test_equalizers_match_reference_vectors(key):
    """MMSE 1xN and ZF 1xN / LxN against the reference closed forms
    (equalize_mmse_1xn.h, equalize_zf_1xn.h, equalize_zf_2xn.h)."""
    algo, nlayers = key.split("_")[0], int(key.split("_")[3][1:])
    y = T(np.ascontiguousarray(np.transpose(_EQ[f"{key}_rx"], (1, 0, 2))))[None]  # (1, nre, P, 2)
    h = T(np.ascontiguousarray(np.transpose(_EQ[f"{key}_est"], (2, 0, 1, 3))))[None]
    nv = T(_EQ[f"{key}_nvar"])[None]
    if nlayers == 1:
        fn = equalization.equalize_mmse_1xn if algo == "mmse" else equalization.equalize_zf_1xn
        sym, out_nv = fn(y, h[..., 0, :], nv)
        sym, out_nv = sym[0][:, None], out_nv[0][:, None]
    else:
        w, out_nv = equalization.zf_weights(h, nv)
        sym, out_nv = equalization.apply_weights(w, y)[0, 0], out_nv[0]
    np.testing.assert_allclose(sym.numpy(), _EQ[f"{key}_eq"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out_nv.numpy(), _EQ[f"{key}_eqnv"], rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------ slots --

def _tx(jcfg, tcfg, batch, seed):
    """TB bits and JAX Tx grids; the port's Tx grids held to them (1e-5)."""
    tb = np.random.default_rng(seed).integers(0, 2, (batch, tcfg.tbs)).astype(np.uint8)
    jgrid = np.asarray(jax_tx_slot(jcfg)(jnp.asarray(tb))[0])
    tgrid = build_ulsch_tx_slot(tcfg, device="cpu")(T(tb))[0]
    np.testing.assert_allclose(tgrid.numpy(), jgrid, rtol=0, atol=1e-5)
    return tb, jgrid


@pytest.mark.parametrize("kw", [
    dict(dmrs_config_type=2, nof_layers=1),
    dict(dmrs_config_type=2, nof_layers=2, equalizer="zf"),
], ids=["type2_1l", "type2_2l_zf"])
def test_slot_options_match_jax(kw):
    """DM-RS type 2 at 1 layer (single-layer type 2 takes the CDM
    estimator branch) and at 2 layers with ZF over 4 ports."""
    jcfg, tcfg = _configs(**kw)
    tb, jgrid = _tx(jcfg, tcfg, batch=2, seed=len(kw))
    samples, _ = _samples(jcfg, jgrid, seed=5)
    to = build_pusch_rx_slot(tcfg, device="cpu")(T(samples))
    _compare(jax_rx_slot(jcfg)(jnp.asarray(samples)), to, tcfg.segmentation)
    assert to["tb_crc_ok"].all()
    np.testing.assert_array_equal(flatten_tb_bits(to["tb_bits_cb"].numpy(), tcfg.tbs), tb)


def test_hopping_slot_matches_jax():
    """One layer over 2 ports, DM-RS on symbols 2 and 9, second hop from
    symbol 7 at PRB 12: a different frequency-selective channel on each hop
    (opposite delay ramps and a gain step), per-hop estimates and per-hop
    single-layer ZF."""
    jcfg, tcfg = _configs(nof_layers=1, nof_rx_ports=2, dmrs_symbols=(2, 9), hop_symbol=7,
                          second_hop_prb=12, equalizer="zf")
    tb, jgrid = _tx(jcfg, tcfg, batch=2, seed=7)
    g = jgrid[..., 0] + 1j * jgrid[..., 1]  # (B, 14, S)
    f = np.arange(tcfg.nof_subc) / tcfg.nof_subc
    hop = (np.arange(14) >= 7).astype(int)
    h = np.stack([np.stack([np.exp(2j * np.pi * 2.0 * f), 0.8 * np.exp(2j * np.pi * 1.0 * f)]),
                  np.stack([0.6 * np.exp(-2j * np.pi * 2.0 * f), np.exp(-1j * f)])])  # (hop, P, S)
    rx = np.einsum("tps,bts->bpts", h[hop], g)
    rng = np.random.default_rng(8)
    rx = rx + 0.01 * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
    grid = np_to_pair(rx)
    to = build_pusch_rx_from_grid(tcfg, device="cpu")(T(grid))
    _compare(jax_from_grid(jcfg)(jnp.asarray(grid)), to, tcfg.segmentation)
    assert to["tb_crc_ok"].all()
    np.testing.assert_array_equal(flatten_tb_bits(to["tb_bits_cb"].numpy(), tcfg.tbs), tb)


@pytest.mark.parametrize("kw", [
    dict(nof_layers=1),
    dict(nof_layers=2, nof_harq_ack_bits=2, nof_csi_part1_bits=5, nof_csi_part2_bits=6),
], ids=["sch_1l", "uci_2l"])
def test_dynamic_params_slot_matches_jax(kw):
    """Three UEs with distinct rnti and n_id in one call of one program; each
    UE's slot is made by the port's Tx with its own configuration."""
    jcfg, tcfg = _configs(dynamic_params=True, **kw)
    ues = [(0x4601 + 7 * i, 3 + 100 * i) for i in range(3)]
    tbs, uci, grids = [], [], []
    for i, (rnti, n_id) in enumerate(ues):
        tu = dataclasses.replace(tcfg, dynamic_params=False, rnti=rnti, n_id=n_id)
        rng = np.random.default_rng(20 + i)
        tb = rng.integers(0, 2, (1, tcfg.tbs)).astype(np.uint8)
        payloads = _payloads(tu, 1, rng)
        grid = build_ulsch_tx_slot(tu, device="cpu")(T(tb), **{k: T(v)
                                                             for k, v in payloads.items()})[0]
        tbs.append(tb[0])
        uci.append(payloads)
        grids.append(_samples(jcfg, grid.numpy(), seed=30 + i, delay=0, cfo_hz=0.0)[1][0])
    grid = np.stack(grids)
    ue_cfgs = [dataclasses.replace(tcfg, rnti=r, n_id=n) for r, n in ues]
    ref, signs, uci_fix = dynamic_inputs(tcfg, ue_cfgs)
    to = dict(build_pusch_rx_from_grid(tcfg, device="cpu")(
        T(grid), None, T(ref), T(signs), tuple(None if f is None else T(f) for f in uci_fix)))
    jo = dict(jax_from_grid(jcfg)(jnp.asarray(grid), None, jnp.asarray(ref), jnp.asarray(signs),
                                  tuple(None if f is None else jnp.asarray(f) for f in uci_fix)))
    t = compare_uci(jo, to, tcfg.segmentation)
    assert to["tb_crc_ok"].all()
    np.testing.assert_array_equal(flatten_tb_bits(to["tb_bits_cb"].numpy(), tcfg.tbs),
                                  np.stack(tbs))
    for name in uci[0]:
        key = "harq_ack_bits" if name == "ack_bits" else name
        np.testing.assert_array_equal(t[key].numpy(), np.concatenate([u[name] for u in uci]))
