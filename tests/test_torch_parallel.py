"""PyTorch port, `parallel/` (mesh, multi_cell, cb_shard, sample_shard,
distributed) against the JAX package: the cases of tests/test_parallel.py.

Each case runs three ways: at world 1 with no process group (the card's
default, mesh None), in 2 and 4 ranks spawned with `torch.multiprocessing`
over gloo (1-D axes, and a 2x2 ("cell", "sp") mesh for the sample axis with
cells on the batch dim), and -- for the JAX side -- the JAX function on its
8 virtual CPU devices in a fresh interpreter (`run_isolated`): the JAX
programs here are sharded over the 8 devices, and a fresh process keeps the
known native XLA:CPU crash of long-lived workers out of this one.  JAX is
imported only there, so the spawned ranks never load it.

Tolerances and why:
  * decoded bits, CRC flags, iteration counts, row blocks: equal;
  * FIR against np.convolve: rtol/atol 1e-5 (1e-4 for complex taps), as the
    JAX test; against the JAX FIR and across world sizes: the same;
  * sample-sharded OFDM demodulation against `ops.ofdm.ofdm_demodulate` and
    JAX: rtol 1e-4, atol 1e-5, as the JAX test (FFTs of other sizes and
    sums in another order).
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig, flatten_tb_bits
from srsran_projectvtlmo_tpu_torch.ops import ofdm
from srsran_projectvtlmo_tpu_torch.ops.crc import crc_host
from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode as plain
from srsran_projectvtlmo_tpu_torch.ops.ldpc.encode import ldpc_encode
from srsran_projectvtlmo_tpu_torch.parallel import (
    build_multi_cell_pusch_rx, build_multi_cell_ulsch_tx, cell_mesh, shard_leading)
from srsran_projectvtlmo_tpu_torch.parallel.cb_shard import (
    build_sharded_ldpc_decode, build_sharded_ldpc_decode_es)
from srsran_projectvtlmo_tpu_torch.parallel.distributed import make_ran_mesh, mesh_shape
from srsran_projectvtlmo_tpu_torch.parallel.mesh import gather
from srsran_projectvtlmo_tpu_torch.parallel.sample_shard import (
    _demod_plan, fir_filter_overlap_save, shard_samples, sharded_ofdm_demodulate)
from srsran_projectvtlmo_tpu_torch.ran.ldpc_params import BaseGraph
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ harnesses --

def run_isolated(target: str, payload, timeout: int = 900):
    """`module:function`(payload) in a fresh interpreter set up as the tests
    are (tests/conftest.py: JAX on 8 virtual CPU devices, the compile
    cache); its result comes back pickled.  A signal death (the known native
    XLA:CPU crash) is retried once, a Python failure (rc > 0) fails at once."""
    module, func = target.split(":")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(payload, f)
        code = ("import importlib, pickle\n"
                "import tests.conftest\n"
                f"fn = getattr(importlib.import_module({module!r}), {func!r})\n"
                f"res = fn(pickle.load(open({src!r}, 'rb')))\n"
                f"pickle.dump(res, open({dst!r}, 'wb'))\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        last = None
        for _ in range(2):
            last = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                                  capture_output=True, text=True, timeout=timeout)
            if last.returncode == 0:
                with open(dst, "rb") as f:
                    return pickle.load(f)
            if last.returncode > 0:
                break
    pytest.fail(f"isolated {target} rc={last.returncode}\n{last.stderr[-3000:]}")


def isolated_future(target: str, payload) -> Future:
    """`run_isolated` started in a thread: the caller goes on (spawning gloo
    ranks, say) while the fresh interpreter works; `.result()` waits."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(run_isolated, target, payload)
    pool.shutdown(wait=False)
    return future


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, out_dir: str, target: str, payload) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        module, func = target.split(":")
        __import__(module)
        res = getattr(sys.modules[module], func)(world, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, target: str, payload) -> list:
    """`module:function`(world, payload) in `world` ranks spawned with a gloo
    process group; every rank's result, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, _free_port(), tmp, target, payload), nprocs=world,
                 join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# --------------------------------------------------------------- inputs --

LOOP_CFG = PuschRxConfig(nof_rb=8, modulation=Modulation.QPSK, target_code_rate=0.4,
                         nof_rx_ports=1, dft_size=128, numerology=1)
#: Real (7,) and complex-pair (5, 2) FIR taps.
FIR_TAPS = {"real": np.random.default_rng(0).normal(size=7).astype(np.float32),
            "complex": np.random.default_rng(1).normal(size=(5, 2)).astype(np.float32)}
DEMOD = dict(dft=256, mu=1, nsubc=96)


def loop_tb() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 2, (8, LOOP_CFG.tbs)).astype(np.uint8)


def cb_llrs(z: int, early_stop: bool) -> tuple[np.ndarray, np.ndarray]:
    """(info bits, LLRs) of 16 BG1 codeblocks: for early stop CRC24B-terminated
    with 5% of the bits flipped at half weight (tests/test_parallel.py's ES
    case), otherwise Gaussian noise on +/-7 (its fixed case)."""
    rng = np.random.default_rng(3 if early_stop else 0)
    k = 22 * z
    if early_stop:
        payload = rng.integers(0, 2, (16, k - 24)).astype(np.uint8)
        info = np.concatenate([payload, np.stack([crc_host(p, "CRC24B") for p in payload])], -1)
    else:
        info = rng.integers(0, 2, (16, k)).astype(np.uint8)
    cw = ldpc_encode(torch.as_tensor(info), BaseGraph.BG1, z).numpy()[:, 2 * z:]
    if early_stop:
        base = ((1 - 2 * cw.astype(np.int32)) * 8).astype(np.int8)
        llr = np.where(rng.random(base.shape) < 0.05, -base // 2, base).astype(np.int8)
    else:
        noisy = (1 - 2 * cw.astype(np.float64)) * 7 + rng.normal(0, 2.0, cw.shape)
        llr = np.clip(np.round(noisy), -20, 20).astype(np.int8)
    return info, llr


def fir_input(kind: str) -> np.ndarray:
    shape = (2, 1024, 2) if kind == "real" else (512, 2)
    return np.random.default_rng(0 if kind == "real" else 1).normal(size=shape).astype(np.float32)


def demod_samples() -> np.ndarray:
    """(2, nsamples, 2): two random grids OFDM-modulated by the port."""
    grid = np.random.default_rng(2).normal(size=(2, 14, DEMOD["nsubc"], 2)).astype(np.float32)
    return ofdm.ofdm_modulate(torch.as_tensor(grid), DEMOD["dft"], DEMOD["mu"], 0).numpy()


# ------------------------------------------ the port, at any world size --

def port_results(world: int, _payload=None) -> dict:
    """Every case's outputs from the port at this world size (mesh None at
    world 1 without a group); numpy."""
    res = {}
    mesh = cell_mesh(device="cpu")
    tx = build_multi_cell_ulsch_tx(LOOP_CFG, mesh, device="cpu")
    rx = build_multi_cell_pusch_rx(LOOP_CFG, mesh, device="cpu")
    _, samples = tx(torch.as_tensor(loop_tb()))
    out = rx(samples[:, None])
    res["loopback"] = {"tb_crc_ok": out["tb_crc_ok"].numpy(),
                       "tb_bits": flatten_tb_bits(out["tb_bits_cb"].numpy(), LOOP_CFG.tbs),
                       "samples": samples.numpy()}
    x = torch.arange(8 * 3).reshape(8, 3)
    res["shard_leading"] = (shard_leading(x, mesh).numpy(), gather(shard_leading(x, mesh), mesh,
                                                                   "cell").numpy())
    cb = cell_mesh(axis="cb", device="cpu")
    for z in (16, 64):
        _, llr = cb_llrs(z, early_stop=False)
        hard, soft = build_sharded_ldpc_decode(cb, BaseGraph.BG1, z, nof_iterations=4)(
            torch.as_tensor(llr))
        res[("fixed", z)] = (hard.numpy(), soft.numpy())
        _, llr = cb_llrs(z, early_stop=True)
        fn = build_sharded_ldpc_decode_es(cb, BaseGraph.BG1, z, "CRC24B", 22 * z, 6)
        res[("es", z)] = tuple(t.numpy() for t in fn(torch.as_tensor(llr)))
    sp = cell_mesh(axis="sp", device="cpu")
    for kind, taps in FIR_TAPS.items():
        xs = shard_samples(torch.as_tensor(fir_input(kind)), sp)
        res[("fir", kind)] = fir_filter_overlap_save(xs, taps, sp).numpy()
    res["demod"] = sharded_ofdm_demodulate(demod_samples(), DEMOD["nsubc"], DEMOD["dft"],
                                           DEMOD["mu"], sp).numpy()
    if world == 4:
        # Cells on the batch dim over "cell", samples over "sp" of a 2x2 mesh.
        rm = make_ran_mesh(2, 2, device="cpu")
        res["demod_2x2"] = sharded_ofdm_demodulate(
            demod_samples(), DEMOD["nsubc"], DEMOD["dft"], DEMOD["mu"], rm.mesh,
            batch_axis="cell").numpy()
        res["fir_2x2"] = fir_filter_overlap_save(fir_input("real"), FIR_TAPS["real"], rm.mesh,
                                                 batch_axis="cell").numpy()
        default = make_ran_mesh(device="cpu")
        res["mesh_default"] = (default.nof_cells, default.nof_sp)
    return res


def jax_results(loop_samples: np.ndarray) -> dict:
    """The JAX functions of tests/test_parallel.py on the same inputs (the
    loopback's receiver on the port transmitter's samples), on the 8 virtual
    CPU devices (run in a fresh interpreter)."""
    import jax
    import jax.numpy as jnp

    from srsran_projectvtlmo_tpu.models.pusch_rx import flatten_tb_bits as jflatten
    from srsran_projectvtlmo_tpu.ops import ofdm as jofdm
    from srsran_projectvtlmo_tpu.parallel import cell_mesh as jcell_mesh
    from srsran_projectvtlmo_tpu.parallel import shard_leading as jshard_leading
    from srsran_projectvtlmo_tpu.parallel.cb_shard import (
        build_sharded_ldpc_decode as jfixed, build_sharded_ldpc_decode_es as jes)
    from srsran_projectvtlmo_tpu.parallel.multi_cell import build_multi_cell_pusch_rx as jrx
    from srsran_projectvtlmo_tpu.parallel.sample_shard import (
        fir_filter_overlap_save as jfir, shard_samples as jshard_samples,
        sharded_ofdm_demodulate as jdemod)
    from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph as JBaseGraph
    from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig as JCfg
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation as JModulation

    res = {}
    mesh = jcell_mesh(8)
    jcfg = JCfg(nof_rb=8, modulation=JModulation.QPSK, target_code_rate=0.4, nof_rx_ports=1,
                dft_size=128, numerology=1)
    with mesh:
        out = jrx(jcfg, mesh)(jshard_leading(jnp.asarray(loop_samples[:, None]), mesh))
        res["loopback"] = {"tb_crc_ok": np.asarray(out["tb_crc_ok"]),
                           "tb_bits": jflatten(np.asarray(out["tb_bits_cb"]), jcfg.tbs)}
    cb = jcell_mesh(8, axis="cb")
    for z in (16, 64):
        _, llr = cb_llrs(z, early_stop=False)
        with cb:
            hard, soft = jfixed(cb, JBaseGraph.BG1, z, nof_iterations=4)(
                jshard_leading(jnp.asarray(llr), cb, axis="cb"))
        res[("fixed", z)] = (np.asarray(hard), np.asarray(soft))
        _, llr = cb_llrs(z, early_stop=True)
        with cb:
            outs = jes(cb, JBaseGraph.BG1, z, "CRC24B", 22 * z, 6, axis="cb")(
                jshard_leading(jnp.asarray(llr), cb, axis="cb"))
        res[("es", z)] = tuple(np.asarray(jax.block_until_ready(t)) for t in outs)
    sp = jcell_mesh(8, axis="sp")
    for kind, taps in FIR_TAPS.items():
        with sp:
            xs = jshard_samples(jnp.asarray(fir_input(kind)), sp)
            res[("fir", kind)] = np.asarray(jfir(xs, taps, sp))
    with sp:
        res["demod"] = np.asarray(jdemod(demod_samples(), DEMOD["nsubc"], DEMOD["dft"],
                                         DEMOD["mu"], sp))
    res["demod_local"] = np.asarray(jofdm.ofdm_demodulate(
        jnp.asarray(demod_samples()), DEMOD["nsubc"], DEMOD["dft"], DEMOD["mu"], 0))
    return res


@pytest.fixture(scope="module")
def world1():
    return port_results(1)


@pytest.fixture(scope="module")
def jax_future(world1):
    return isolated_future("tests.test_torch_parallel:jax_results", world1["loopback"]["samples"])


@pytest.fixture(scope="module")
def jax_side(jax_future):
    return jax_future.result()


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    return request.param, run_ranks(request.param, "tests.test_torch_parallel:port_results", None)


# ---------------------------------------------------------------- tests --

def test_ranks_equal_world1(world1, jax_future, ranks):
    """Every rank of a 2- and a 4-rank gloo group returns the world-1
    results: the same global tensors, bit for bit where they are bits,
    within the FIR/demod tolerance where they are floats.  First in the
    file, so that the JAX side (`jax_future`) runs beside the ranks."""
    world, per_rank = ranks
    for rank, res in enumerate(per_rank):
        for key, want in world1.items():
            got = res[key]
            if key == "shard_leading":
                np.testing.assert_array_equal(got[0], want[0][rank * 8 // world:
                                                              (rank + 1) * 8 // world])
                np.testing.assert_array_equal(got[1], want[1])
            elif key == "demod" or key[0] == "fir":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            elif key == "loopback":
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=str(key))
        if world == 4:
            np.testing.assert_allclose(res["demod_2x2"], world1["demod"], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(res["fir_2x2"], world1[("fir", "real")], rtol=1e-5,
                                       atol=1e-5)
            assert res["mesh_default"] == (2, 2)


def test_eight_cell_loopback_decodes_and_matches_jax(world1, jax_side):
    got = world1["loopback"]
    assert got["tb_crc_ok"].shape == (8,) and got["tb_crc_ok"].all()
    np.testing.assert_array_equal(got["tb_bits"], loop_tb())
    np.testing.assert_array_equal(got["tb_crc_ok"], jax_side["loopback"]["tb_crc_ok"])
    np.testing.assert_array_equal(got["tb_bits"], jax_side["loopback"]["tb_bits"])


def test_shard_leading_world1_is_whole_and_rejects_uneven_rows():
    x = torch.arange(12).reshape(6, 2)
    assert shard_leading(x, None) is not None and torch.equal(shard_leading(x, None), x)
    assert cell_mesh(device="cpu") is None and cell_mesh(1, device="cpu") is None
    assert gather(x, None, "cell") is x


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("z", [16, 64])
def test_cb_sharded_decode_bit_exact(world1, jax_side, z, early_stop):
    """The CB-sharded decode equals the unsharded port decode and JAX's
    sharded decode (hard, soft and, with early stop, crc_ok and iterations)."""
    info, llr = cb_llrs(z, early_stop)
    key = ("es" if early_stop else "fixed", z)
    if early_stop:
        want = plain.ldpc_decode_es(torch.as_tensor(llr), BaseGraph.BG1, z, "CRC24B", 22 * z,
                                    nof_iterations=6)
    else:
        want = plain.ldpc_decode(torch.as_tensor(llr), BaseGraph.BG1, z, nof_iterations=4)
    assert len(world1[key]) == len(want) == len(jax_side[key])
    for got, w, j in zip(world1[key], want, jax_side[key]):
        np.testing.assert_array_equal(got, w.numpy())
        np.testing.assert_array_equal(got, j)
    if early_stop:
        assert world1[key][2].all() and (world1[key][0] == info).all()


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_overlap_save_fir_matches_convolve_and_jax(world1, jax_side, kind):
    x, taps = fir_input(kind), FIR_TAPS[kind]
    tc = taps if taps.ndim == 1 else taps[:, 0] + 1j * taps[:, 1]
    xc = x[..., 0] + 1j * x[..., 1]
    n = x.shape[-2]
    ref = np.stack([np.convolve(row, tc)[:n] for row in xc.reshape(-1, n)]).reshape(xc.shape)
    tol = 1e-5 if kind == "real" else 1e-4
    y = world1[("fir", kind)]
    np.testing.assert_allclose(y[..., 0] + 1j * y[..., 1], ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(y, jax_side[("fir", kind)], rtol=tol, atol=tol)


def test_sharded_ofdm_demodulate_matches_local_and_jax(world1, jax_side):
    want = ofdm.ofdm_demodulate(torch.as_tensor(demod_samples()), DEMOD["nsubc"], DEMOD["dft"],
                                DEMOD["mu"], 0).numpy()
    np.testing.assert_allclose(world1["demod"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(world1["demod"], jax_side["demod"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(jax_side["demod_local"], want, rtol=1e-4, atol=1e-5)


def test_demod_plan_rejects_a_halo_wider_than_a_shard():
    nsamp = ofdm.slot_sample_count(256, 1, 0)
    with pytest.raises(ValueError, match="too small for 256-point windows"):
        _demod_plan(nsamp - nsamp % 32, 32, 256, 1, 0, "normal")
    _demod_plan(nsamp - nsamp % 8, 8, 256, 1, 0, "normal")


@pytest.mark.parametrize("args", [(None, None), (None, 2), (8, None), (1, 8), (4, 2)])
def test_mesh_shape_defaults_as_jax(args):
    """The port's (cell, sp) defaulting on 8 devices of one host equals the
    JAX make_ran_mesh's over the 8 virtual devices."""
    from srsran_projectvtlmo_tpu.parallel.distributed import make_ran_mesh as jmake

    j = jmake(*args)
    assert mesh_shape(8, 1, *args) == (j.nof_cells, j.nof_sp)


def test_mesh_shape_assertions():
    with pytest.raises(AssertionError):
        mesh_shape(8, 1, 3, 3)
    with pytest.raises(AssertionError):
        mesh_shape(8, 1, 3)
    with pytest.raises(AssertionError, match="host boundaries"):
        mesh_shape(12, 4, 6, 2)
    assert mesh_shape(8, 2) == (2, 4)  # two hosts: cells across hosts
    assert mesh_shape(1, 1) == (1, 1)
    rm = make_ran_mesh(device="cpu")
    assert (rm.mesh, rm.nof_cells, rm.nof_sp) == (None, 1, 1)
    with pytest.raises(AssertionError):
        make_ran_mesh(2, 1, device="cpu")
