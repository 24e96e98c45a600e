"""PyTorch port, the LDPC kernel's host-side plan and arithmetic, on the CPU.

The CUDA kernel (`csrc/ldpc_decode.cu`) runs only on the card, where
chip_smoke.py holds it bit for bit against the plain decoder.  What it is
given and how it computes are checked here at every lifting size of both base
graphs: the barrier groups, the packed edge words, the scale table, the
reduced saturating rules (exhaustively, against the general ones), and a
numpy mirror of the kernel's row update and group schedule against the plain
decoder, both modes.
"""

import re

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.ran.ldpc_params import ALL_LIFTING_SIZES, BaseGraph

from srsran_projectvtlmo_tpu_torch.ops.crc import xor_reduce
from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode, decode_cuda as dc
from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import get_graph
from srsran_projectvtlmo_tpu_torch.utils import llr
from tests.test_torch_ldpc import _codewords, _noisy

_BGS = [BaseGraph.BG1, BaseGraph.BG2]


def _row_cols(g, r):
    return g.row_cols[r][g.row_cols[r] >= 0]


def _parity(x):
    """Parity of each int64's low 32 bits (the kernel's __popc(x) & 1)."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


@pytest.mark.parametrize("bg", _BGS)
def test_row_groups_hold_every_row_once_and_are_column_disjoint(bg):
    for z in ALL_LIFTING_SIZES:
        g = get_graph(bg, z)
        ends = dc.row_groups(bg, z)
        starts = np.concatenate([[0], ends[:-1]])
        assert ends[-1] == g.m and (ends > starts).all(), z
        rows = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
        np.testing.assert_array_equal(rows, np.arange(g.m))
        for s, e in zip(starts, ends):
            cols = np.concatenate([_row_cols(g, r) for r in range(s, e)])
            assert len(np.unique(cols)) == len(cols), (z, s, e)
            if e < g.m:  # greedy: the next row would share a column
                assert np.intersect1d(cols, _row_cols(g, e)).size, (z, e)
        assert len(ends) == (32 if bg == BaseGraph.BG1 else 28)


@pytest.mark.parametrize("bg", _BGS)
def test_plan_edge_words_agree_with_graph(bg):
    lanes = np.arange(384)
    for z in ALL_LIFTING_SIZES:
        g = get_graph(bg, z)
        plan = dc.kernel_plan(bg, z, 0.8)
        assert plan.shape == () and plan.dtype == dc.PLAN_DTYPE
        groups = dc.row_groups(bg, z)
        assert [int(plan[f]) for f in ("z", "nv", "m", "kb", "ngroups")] == \
            [z, g.n_full, g.m, g.kb, len(groups)]
        np.testing.assert_array_equal(plan["group_end"][:len(groups)], groups)
        assert not plan["group_end"][len(groups):].any()
        row_ptr = plan["row_ptr"][:g.m + 1]
        assert row_ptr[-1] == (g.shifts >= 0).sum() <= dc.PLAN_MAX_EDGES
        # The kernel compiles a row update for these degrees (decode_row_any).
        assert set(np.diff(row_ptr)) <= {3, 4, 5, 6, 7, 8, 9, 10, 19}
        edges = plan["edge"][:row_ptr[-1]]
        assert not plan["edge"][row_ptr[-1]:].any()
        shift, colz = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
        i = lanes[:z]
        for r in range(g.m):
            e = slice(row_ptr[r], row_ptr[r + 1])
            cols, shifts = _row_cols(g, r), g.row_shifts[r, :row_ptr[r + 1] - row_ptr[r]]
            np.testing.assert_array_equal(colz[e], cols * z, err_msg=f"{z} {r}")
            np.testing.assert_array_equal(shift[e], shifts, err_msg=f"{z} {r}")
            # The kernel's rotated index (unsigned min) is the plain decoder's gather index.
            j = (i[None] + shift[e, None]).astype(np.uint32)
            idx = colz[e, None] + np.minimum(j, j - np.uint32(z))
            np.testing.assert_array_equal(idx.reshape(-1), decode._row_index(bg, z, r))


def test_plan_dtype_matches_kernel_struct():
    """The .cu file's offsetof/sizeof assertions on `Plan` (which nvcc
    checks) and its table sizes agree with PLAN_DTYPE field by field."""
    src = dc.SOURCE.read_text()
    offsets = {f: int(o) for f, o in
               re.findall(r"static_assert\(offsetof\(Plan, (\w+)\) == (\d+)", src)}
    assert offsets == {f: dc.PLAN_DTYPE.fields[f][1] for f in dc.PLAN_DTYPE.names}
    assert list(offsets) == list(dc.PLAN_DTYPE.names)  # declared in the same order
    assert int(re.search(r"static_assert\(sizeof\(Plan\) == (\d+)", src)[1]) \
        == dc.PLAN_DTYPE.itemsize
    for name, value in (("kMaxRows", dc.PLAN_MAX_ROWS), ("kMaxEdges", dc.PLAN_MAX_EDGES)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src)[1]) == value
    assert dc.PLAN_DTYPE.fields["edge"][1] % 8 == 0  # int2 alignment


@pytest.mark.parametrize("sf", [0.8, 0.75, 1.0])
def test_plan_scale_table_is_float32_round_half_up(sf):
    m = np.arange(121, dtype=np.float32)
    want = np.floor(m * np.float32(sf) + np.float32(0.5)).astype(np.int32)
    for bg, z in [(BaseGraph.BG1, 384), (BaseGraph.BG2, 7)]:
        lut = dc.kernel_plan(bg, z, sf)["lut"]
        np.testing.assert_array_equal(lut[:121], want)
        assert lut[:121].max() <= llr.LLR_MAX  # so |c2v| <= 120 in the kernel
    with pytest.raises(ValueError):
        dc._plan(BaseGraph.BG1, 384, 1.25)


# The kernel's arithmetic (csrc/ldpc_decode.cu), valid while |c2v| <= 120:
# shared memory holds +/-127 as +/-121, v2c carries it as +/-(242..362), and
# the update is one clamp.
SOFT_INF = 121


def _encode(a):
    return torch.where(a.abs() == llr.LLR_INFTY, torch.sign(a) * SOFT_INF,
                       torch.clamp(a, -llr.LLR_MAX, llr.LLR_MAX))


def _decode_soft(a):
    return torch.where(a.abs() == SOFT_INF, torch.sign(a) * llr.LLR_INFTY, a)


def _kernel_v2c(a, c):
    b = torch.clamp(a, -llr.LLR_MAX, llr.LLR_MAX)
    return torch.clamp(b - c, -llr.LLR_MAX, llr.LLR_MAX) + 2 * SOFT_INF * (a - b)


def _kernel_update(v, c):
    return torch.clamp(v + c, -SOFT_INF, SOFT_INF)


def _same_for_the_decoder(got, want):
    """The kernel's v2c against the general one: the same sign, the same
    magnitude clipped at 120 (all the min search sees), equal where finite,
    and beyond 241 where infinite (so the update saturates)."""
    inf = want.abs() == llr.LLR_INFTY
    assert torch.equal(got < 0, want < 0)
    assert torch.equal(got.abs().clamp(max=llr.LLR_MAX), want.abs().clamp(max=llr.LLR_MAX))
    assert torch.equal(got[~inf], want[~inf]) and bool((got[inf].abs() >= 242).all())


def test_kernel_saturating_rules_equal_general_ones():
    """Every stored soft value ([-121, 121]) against every c2v in [-120, 120];
    every input LLR (all of int8) at its first touch (c2v = 0), after the
    kernel's load encoding; every v2c against every new c2v for the update."""
    c = torch.arange(-llr.LLR_MAX, llr.LLR_MAX + 1, dtype=torch.int32)
    a = torch.arange(-SOFT_INF, SOFT_INF + 1, dtype=torch.int32)
    aa, ca = torch.meshgrid(a, c, indexing="ij")
    want = decode._sat_sub(_decode_soft(aa), ca)
    np.testing.assert_array_equal(want.numpy(), llr.llr_saturating_add(
        _decode_soft(aa).to(torch.int8), (-ca).to(torch.int8)).numpy())
    _same_for_the_decoder(_kernel_v2c(aa, ca), want)
    raw = torch.arange(-128, 128, dtype=torch.int32)
    _same_for_the_decoder(_kernel_v2c(_encode(raw), torch.zeros_like(raw)),
                          decode._sat_sub(raw, torch.zeros_like(raw)))
    v = torch.arange(-llr.LLR_INFTY, llr.LLR_INFTY + 1, dtype=torch.int32)
    vv, cv = torch.meshgrid(v, c, indexing="ij")
    want = decode._promotion_sum(cv, vv)
    np.testing.assert_array_equal(want.numpy(), llr.llr_promotion_sum(
        cv.to(torch.int8), vv.to(torch.int8)).numpy())
    for kv in (torch.where(vv.abs() == llr.LLR_INFTY, 242 * torch.sign(vv), vv),
               torch.where(vv.abs() == llr.LLR_INFTY, 362 * torch.sign(vv), vv)):
        assert torch.equal(_decode_soft(_kernel_update(kv, cv)), want)


class _KernelMirror:
    """numpy mirror of the kernel: the plan's edge words and groups, the
    packed c2v state, the register v2c, the scale table.  Rows of a group read
    the soft bits as they were at the group's barrier, then write, as the
    kernel's threads do between two barriers."""

    def __init__(self, llrs: np.ndarray, bg: BaseGraph, z: int, sf: float):
        self.plan = dc.kernel_plan(bg, z, sf)
        self.z, self.m, self.kb = (int(self.plan[f]) for f in ("z", "m", "kb"))
        self.ends = self.plan["group_end"][:int(self.plan["ngroups"])]
        self.row_ptr = self.plan["row_ptr"][:self.m + 1]
        self.edges = self.plan["edge"][:self.row_ptr[-1]].astype(np.int64)
        self.lut = self.plan["lut"].astype(np.int64)
        b = llrs.shape[0]
        enc = _encode(torch.as_tensor(llrs.astype(np.int64))).numpy()
        self.soft = np.concatenate([np.zeros((b, 2 * z), np.int64), enc], 1)
        self.state = np.zeros((b, self.m, z), np.uint64)
        self.min2 = np.zeros((b, self.m, z), np.int64)

    def _row(self, r, soft_in):
        z, lane = self.z, np.arange(self.z)
        old = self.state[:, r]
        s1o, s2o = (old >> 24).astype(np.int64), self.min2[:, r]
        amo = ((old >> 19) & 0x1F).astype(np.int64)
        sign_mask = (1 << 19) - 1
        sbo = (old & sign_mask).astype(np.int64)
        neg_old = sbo ^ np.where(_parity(sbo) == 1, sign_mask, 0)
        m1 = np.full(old.shape, 120, np.int64)
        m2, am, sb = m1.copy(), np.zeros_like(m1), np.zeros_like(m1)
        writes, v2cs = [], []
        for e, (shift, colz) in enumerate(self.edges[self.row_ptr[r]:self.row_ptr[r + 1]]):
            j = (lane + shift).astype(np.uint32)
            idx = colz + np.minimum(j, j - np.uint32(z)).astype(np.int64)
            a = soft_in[:, idx]
            mag = np.where(amo == e, s2o, s1o)
            c = np.where((neg_old >> e) & 1 == 1, -mag, mag)
            b = np.clip(a, -120, 120)
            v = np.clip(b - c, -120, 120) + 2 * SOFT_INF * (a - b)
            av = np.abs(v)
            am = np.where(av < m1, e, am)
            m2 = np.minimum(m2, np.maximum(av, m1))
            m1 = np.minimum(m1, av)
            sb |= (v < 0).astype(np.int64) << e
            writes.append(idx)
            v2cs.append(v)
        s1, s2 = self.lut[m1], self.lut[m2]
        neg = sb ^ np.where(_parity(sb) == 1, sign_mask, 0)
        out = []
        for e, (idx, v) in enumerate(zip(writes, v2cs)):
            mag = np.where(am == e, s2, s1)
            c = np.where((neg >> e) & 1 == 1, -mag, mag)
            out.append((idx, np.clip(v + c, -SOFT_INF, SOFT_INF)))
        self.state[:, r] = (sb | (am << 19) | (s1 << 24)).astype(np.uint64)
        self.min2[:, r] = s2
        return out

    def sweep(self):
        start = 0
        for end in self.ends:
            soft_in = self.soft.copy()
            for r in range(start, end):
                for idx, val in self._row(r, soft_in):
                    self.soft[:, idx] = val
            start = end

    def systematic(self):
        return _decode_soft(torch.as_tensor(self.soft[:, :self.kb * self.z])).numpy()


@pytest.mark.parametrize("bg,z", [(BaseGraph.BG1, 7), (BaseGraph.BG1, 26), (BaseGraph.BG2, 2),
                                  (BaseGraph.BG2, 15)])
def test_kernel_mirror_bit_exact_with_plain_decoder(bg, z):
    """Fixed iterations (hard, soft) and early stop (all four outputs) on
    rows from clean to undecodable, the last uniform over all of int8."""
    crc = "CRC16" if z == 2 else "CRC24B"  # BG2 z=2 holds 20 bits
    _, cw_llr, kp = _codewords(bg, z, 6, seed=z + 40, crc=crc)
    noisy = _noisy(cw_llr, seed=z + 41)
    iters = 4
    mirror = _KernelMirror(noisy, bg, z, 0.8)
    mask = decode.packed_crc_mask(bg, z, crc, kp)
    b = noisy.shape[0]
    done = np.zeros(b, bool)
    frozen = np.zeros((b, mirror.kb * z), np.int64)
    used = np.full(b, iters)
    for it in range(iters):
        mirror.sweep()
        info = mirror.systematic()
        ok = xor_reduce(torch.as_tensor((info <= 0).astype(np.int32) * mask)).numpy() == 0
        newly = ok & ~done
        frozen[newly], used[newly] = info[newly], it + 1
        done |= ok
    es_soft = np.where(done[:, None], frozen, mirror.systematic())
    want = decode.ldpc_decode_es(torch.as_tensor(noisy), bg, z, crc, kp,
                                 nof_iterations=iters)
    np.testing.assert_array_equal(es_soft, want[1].numpy())
    np.testing.assert_array_equal((es_soft <= 0).astype(np.uint8), want[0].numpy())
    np.testing.assert_array_equal(done, want[2].numpy())
    np.testing.assert_array_equal(used, want[3].numpy())
    assert done.any() and not done.all()
    _, fixed_soft = decode.ldpc_decode(torch.as_tensor(noisy), bg, z, nof_iterations=iters)
    np.testing.assert_array_equal(mirror.systematic(), fixed_soft.numpy())
