"""PyTorch port, foundations: import hygiene, int8 LLR ops, LDPC graphs, SCH
configuration, CRC and the host tables they derive, each held against the
JAX package on the same numpy inputs."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models import sch_config as jax_sch
from srsran_projectvtlmo_tpu.ops import crc as jax_crc
from srsran_projectvtlmo_tpu.ops.ldpc import graphs as jax_graphs
from srsran_projectvtlmo_tpu.ran.ldpc_params import ALL_LIFTING_SIZES, BaseGraph
from srsran_projectvtlmo_tpu.ran.modulation import Modulation
from srsran_projectvtlmo_tpu.utils import llr as jax_llr

from srsran_projectvtlmo_tpu_torch.models import sch_config
from srsran_projectvtlmo_tpu_torch.ops import crc
from srsran_projectvtlmo_tpu_torch.ops.ldpc import graphs
from srsran_projectvtlmo_tpu_torch.utils import cplx, llr
from tests.test_torch_host_copies import port_kw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_MODULES = ("models.pusch_rx", "models.sch_config", "models.sch_tx", "models.ulsch_tx",
            "models.channel", "ops.ldpc.encode", "ops.ldpc.segment", "ops.ldpc.decode_cuda",
            "ops.modulation", "ops.demodulation", "ops.precoding", "ops.prg", "ops.dmrs",
            "ops.ulsch_demux", "ops.equalization", "ops.short_block", "ops.uci",
            "ops.polar.code", "ops.polar.allocate", "ops.polar.encode", "ops.polar.rate_match",
            "ops.polar.decode", "phy.pusch_uci", "ran.ldpc_params", "ran.modulation", "ran.sch",
            "ran.ulsch_info", "fapi.pdus", "fapi.validators", "ops.low_papr", "ops.prach",
            "ops.srs", "phy.error_handler", "phy.harq", "phy.prach_buffer",
            "phy.pucch", "phy.realtime", "phy.upper_phy", "phy.warmup", "ran.prach_config",
            "ran.prach_cyclic_shifts", "ran.prach_preamble", "ops.polar.interleave", "ops.csi_rs",
            "ran.re_pattern", "ran.pdcch_mapping", "phy.pbch", "phy.pdcch", "models.pdsch_tx",
            "phy.dl_slot", "parallel.distributed", "parallel.mesh", "parallel.multi_cell",
            "parallel.multi_cell_phy", "parallel.cb_shard", "parallel.sample_shard",
            "ran.mcs", "ran.slot", "utils.tracing", "utils.log", "utils.config",
            "utils.sanitizer", "utils.bits", "phy.rx_symbol_handler", "phy.lower",
            "radio.gateway", "ops.ofh_compression", "ofh.ecpri", "ofh.ethernet", "ofh.cplane",
            "ofh.uplane", "ofh.reception", "native", "apps.gnb_sim", "entry")
_FOREIGN = ("jax", "srsran_projectvtlmo_tpu")


def test_import_leaves_jax_out():
    """Every module of the port (the listed ones among them: the app and the
    entry module too) imports without pulling in jax or any module of the
    JAX package, nor PyYAML, which only `utils.config.load_config` needs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import srsran_projectvtlmo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {_MODULES!r} if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_FOREIGN!r})\n"
        "assert not bad, bad\n"
        "assert 'yaml' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def _imported_roots(path: str) -> set[str]:
    """Top-level package of every import statement in a Python source;
    relative imports count as the port's own."""
    roots = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add("." if node.level else node.module.split(".")[0])
    return roots


def test_no_jax_import_in_package_sources():
    pkg = os.path.join(REPO, "srsran_projectvtlmo_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "import jax" not in text and "from jax" not in text, f
                assert not _imported_roots(os.path.join(root, f)) & set(_FOREIGN), f


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py runs where JAX is not installed: its imports, at top
    level and inside functions, name neither jax nor the JAX package."""
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "srsran_projectvtlmo_tpu_torch" in roots
    assert not roots & set(_FOREIGN), roots & set(_FOREIGN)


def test_parallel_imports_no_private_name_of_phy():
    """`parallel/` reaches `phy/` only through its public names: no module
    there imports a `_`-prefixed name from the port's `phy` package."""
    pkg = os.path.join(REPO, "srsran_projectvtlmo_tpu_torch", "parallel")
    bad = []
    for f in sorted(os.listdir(pkg)):
        if not f.endswith(".py"):
            continue
        path = os.path.join(pkg, f)
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if not isinstance(node, ast.ImportFrom):
                continue
            parts = (node.module or "").split(".")
            if node.level:  # relative to srsran_projectvtlmo_tpu_torch.parallel
                parts = ["srsran_projectvtlmo_tpu_torch", "parallel"][:3 - node.level] + parts
            if parts[:2] == ["srsran_projectvtlmo_tpu_torch", "phy"]:
                bad += [(f, a.name) for a in node.names if a.name.startswith("_")]
    assert not bad, bad


_ALL = np.arange(-128, 128, dtype=np.int8)
_A, _B = np.meshgrid(_ALL, _ALL, indexing="ij")


@pytest.mark.parametrize("name", ["llr_saturating_add", "llr_promotion_sum"])
def test_llr_sums_equal_on_all_int8_pairs(name):
    want = np.asarray(getattr(jax_llr, name)(jnp.asarray(_A), jnp.asarray(_B)))
    got = getattr(llr, name)(torch.as_tensor(_A), torch.as_tensor(_B)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("range_limit", [20.0, 24.0])
def test_llr_quantize_and_hard_bit_equal(range_limit):
    rng = np.random.default_rng(0)
    # Dense random values plus every exact rounding midpoint of the scale.
    halves = (np.arange(-241, 242) / 2.0 * range_limit / llr.LLR_MAX).astype(np.float32)
    x = np.concatenate([rng.normal(0, 15, 20000).astype(np.float32), halves,
                        np.float32([0.0, -0.0, 1e9, -1e9])])
    want = np.asarray(jax_llr.llr_quantize(jnp.asarray(x), range_limit))
    got = llr.llr_quantize(torch.as_tensor(x), range_limit).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(llr.llr_to_hard_bit(torch.as_tensor(_ALL)).numpy(),
                                  np.asarray(jax_llr.llr_to_hard_bit(jnp.asarray(_ALL))))


def test_complex_pairs_round_trip():
    rng = np.random.default_rng(1)
    z = (rng.normal(size=(3, 5)) + 1j * rng.normal(size=(3, 5))).astype(np.complex64)
    pair = torch.as_tensor(cplx.np_to_pair(z))
    np.testing.assert_array_equal(cplx.to_cplx(pair).numpy(), z)
    np.testing.assert_array_equal(cplx.from_cplx(cplx.to_cplx(pair)).numpy(), pair.numpy())
    np.testing.assert_array_equal(cplx.to_cplx(pair.to(torch.bfloat16)).numpy(),
                                  cplx.to_cplx(pair.to(torch.bfloat16).float()).numpy())


@pytest.mark.parametrize("bg", [BaseGraph.BG1, BaseGraph.BG2])
def test_graphs_equal_for_all_lifting_sizes(bg):
    for z in ALL_LIFTING_SIZES:
        a, b = jax_graphs.get_graph(bg, z), graphs.get_graph(bg, z)
        assert (a.kb, a.m, a.n_full, a.max_row_degree, a.k, a.n) == \
            (b.kb, b.m, b.n_full, b.max_row_degree, b.k, b.n), z
        for field in ("shifts", "row_cols", "row_shifts"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=f"{z} {field}")


_SCH_GRID = [
    dict(nof_rb=24, modulation=Modulation.QAM64, target_code_rate=0.6),
    dict(nof_rb=273, modulation=Modulation.QAM256, target_code_rate=948 / 1024, nof_layers=2),
    dict(nof_rb=52, modulation=Modulation.QPSK, target_code_rate=0.3, dmrs_symbols=(2, 11)),
    dict(nof_rb=6, modulation=Modulation.QAM16, target_code_rate=0.5, nof_ofdm_symbols=12,
         rnti=0x1234, n_id=500, rv=2, nof_layers=4),
    dict(nof_rb=1, modulation=Modulation.QPSK, target_code_rate=0.1),
]


@pytest.mark.parametrize("kw", _SCH_GRID)
def test_sch_config_derived_fields_equal(kw):
    a, b = jax_sch.SchChainConfig(**kw), sch_config.SchChainConfig(**port_kw(kw))
    assert a.tbs == b.tbs
    assert dataclasses.asdict(a.segmentation) == dataclasses.asdict(b.segmentation)
    assert (a.nof_subc, a.data_symbols, a.nof_data_re, a.nof_codeword_bits) == \
        (b.nof_subc, b.data_symbols, b.nof_data_re, b.nof_codeword_bits)
    assert a.cb_rate_match_sizes() == b.cb_rate_match_sizes()
    g = a.nof_codeword_bits - 96 * a.nof_layers
    assert a.cb_rate_match_sizes(g) == b.cb_rate_match_sizes(g)
    assert a.scrambling_cinit() == b.scrambling_cinit()


@pytest.mark.parametrize("name", sorted(crc.POLYS))
def test_crc_bases_equal(name):
    for length in (1, 17, 200, 8448):
        np.testing.assert_array_equal(crc.crc_basis(name, length), jax_crc.crc_basis(name, length))
        np.testing.assert_array_equal(crc.crc_zero_basis(name, length),
                                      jax_crc.crc_zero_basis(name, length))


@pytest.mark.parametrize("name,n", [("CRC24A", 40000), ("CRC24B", 8424), ("CRC16", 300),
                                    ("CRC11", 19), ("CRC6", 12)])
def test_crc_device_and_checks_bit_exact(name, n):
    """crc_device on both sides of JAX's 32768-bit switch to its packed form,
    crc_check_device on valid and corrupted words."""
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (3, n)).astype(np.uint8)
    want = np.asarray(jax_crc.crc_device(jnp.asarray(bits), name))
    got = crc.crc_device(torch.as_tensor(bits), name).numpy()
    np.testing.assert_array_equal(got, want)
    words = np.concatenate([bits, want], axis=-1)
    words[1, 5] ^= 1
    np.testing.assert_array_equal(crc.crc_check_device(torch.as_tensor(words), name).numpy(),
                                  np.asarray(jax_crc.crc_check_device(jnp.asarray(words), name)))
    assert list(crc.crc_check_device(torch.as_tensor(words), name).numpy()) == [True, False, True]
    np.testing.assert_array_equal(crc.crc_host(bits[0], name), jax_crc.crc_host(bits[0], name))


def test_crc_check_device_cbs_bit_exact():
    """TB CRC over per-codeblock payload planes (the PUSCH TB check)."""
    rng = np.random.default_rng(7)
    c, kpay, tbs = 5, 1000, 4970
    payload = rng.integers(0, 2, (4, tbs)).astype(np.uint8)
    tb = np.concatenate([payload, np.stack([jax_crc.crc_host(p, "CRC24A") for p in payload])], -1)
    planes = np.zeros((4, c * kpay), np.uint8)
    planes[:, :tbs + 24] = tb
    planes[2, 17] ^= 1
    planes[3, -1] ^= 1  # past total_len: not covered
    planes = planes.reshape(4, c, kpay)
    want = np.asarray(jax_crc.crc_check_device_cbs(jnp.asarray(planes), "CRC24A", tbs + 24))
    got = crc.crc_check_device_cbs(torch.as_tensor(planes), "CRC24A", tbs + 24).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got) == [True, True, False, True]
