"""The traffic pool: the same seed makes the same pool, another seed another,
and every seed the same sizes."""

import numpy as np
import pytest


def pool_of(cell_of, name, seed):
    from portbench import harness

    _, _, config, traffic = cell_of(name)
    fapi, _, _ = harness.port_modules()
    return harness.kind_of(traffic).make_pool(traffic, config, seed, "cpu", fapi)


def digest(pool):
    out = []
    for e in pool:
        out.append(e.slot)
        for r, data in e.ref["cells"]:
            out += [r.pdsch[0].rnti, r.pdsch[0].n_id, r.ssb[0].sfn, r.pdcch[0].payload,
                    data.tb_bits[0].tobytes()]
    return out


def test_same_seed_same_pool_other_seed_other_pool(cell_of):
    big = 2 ** 31 + 12345
    a, b, c = (pool_of(cell_of, "dl_full_1cell", s) for s in (big, big, big + 1))
    assert digest(a) == digest(b)
    assert digest(a) != digest(c)
    assert len(a) == len(c) == 8
    sizes = [len(d.tb_bits[0]) for e in a for _, d in e.ref["cells"]]
    assert sizes == [len(d.tb_bits[0]) for e in c for _, d in e.ref["cells"]]


def test_pool_slots_distinct_and_both_ofdm_phases(cell_of):
    pool = pool_of(cell_of, "dl_full_1cell", 99)
    assert len({e.slot for e in pool}) == len(pool)
    assert {e.slot % 2 for e in pool} == {0, 1}
    assert len({e.ref["cells"][0][1].tb_bits[0].tobytes() for e in pool}) == len(pool)


def test_a_spec_per_cell(cell_of):
    """A mix may give each cell its own slot: the pool follows it."""
    from portbench import harness

    _, _, config, traffic = cell_of("dl_full_1cell", 2)
    spec = {k: traffic[k] for k in ("pdsch", "pdcch", "ssb", "csi_rs")}
    narrow = dict(spec, pdsch=dict(spec["pdsch"], rb_size=12, modulation="QAM64"))
    traffic["cells"] = [spec, narrow]
    fapi, _, _ = harness.port_modules()
    pool = harness.kind_of(traffic).make_pool(traffic, config, 7, "cpu", fapi)
    (r0, d0), (r1, d1) = pool[0].ref["cells"]
    assert (r0.pdsch[0].rb_size, r1.pdsch[0].rb_size) == (24, 12)
    assert len(d0.tb_bits[0]) > len(d1.tb_bits[0])
