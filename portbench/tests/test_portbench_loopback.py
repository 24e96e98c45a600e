"""At 24 PRB on the CPU: the plain DL reference, written from TS 38.211,
agrees with the port's CPU grid and samples far inside the check's limits,
and puts each channel where the specification puts it."""

import numpy as np
import pytest


def test_gold_sequence_equals_the_frozen_generator():
    from portbench.reference import dl as ref_dl
    from portbench.reference.ops import prg

    for c_init in (0, 1, 5, 12345, 2 ** 31 - 1):
        np.testing.assert_array_equal(ref_dl.gold(c_init, 3000),
                                      prg.gold_sequence_bits(c_init, 3000))


@pytest.mark.parametrize("nof_cells", [1, 2])
def test_plain_dl_reference_agrees_with_the_port_on_the_cpu(cell_of, nof_cells):
    from portbench import harness
    from portbench.reference import dl as ref_dl
    from portbench.traffic import dl_slot

    _, _, config, traffic = cell_of("dl_full_1cell", nof_cells)
    fapi, _, _ = harness.port_modules()
    pool = dl_slot.make_pool(traffic, config, 23, "cpu", fapi)
    phy = harness.make_phy(config, "cpu")
    for e in pool[:2]:
        outs = dl_slot.per_cell_outputs(phy.process_dl_slot(*e.args, fetch=True), nof_cells)
        for (grid, samples), (req, data) in zip(outs, e.ref["cells"]):
            rg, rs = ref_dl.assemble(req, data, config["cell"], "cpu")
            assert np.abs(rg).max() > 0
            assert np.abs(grid - rg).max() <= 1e-6 * np.abs(rg).max()
            assert np.sqrt(np.mean((samples - rs) ** 2) / np.mean(rs ** 2)) < 1e-5


def test_dl_reference_channels_where_the_spec_puts_them(cell_of):
    """Each channel's REs: PDSCH DM-RS on the even subcarriers of symbol 2
    only, the PDCCH's data and DM-RS on its CORESET symbol and port 0, PSS
    and SSS as +/-1 sequences, CSI-RS row 2 at k = 12 n + 3."""
    from portbench import harness
    from portbench.reference import dl as ref_dl
    from portbench.traffic import dl_slot

    _, _, config, traffic = cell_of("dl_full_1cell")
    fapi, _, _ = harness.port_modules()
    req, data = dl_slot.make_pool(traffic, config, 24, "cpu", fapi)[0].ref["cells"][0]
    grid = np.zeros((4, 14, 288), complex)
    ref_dl.map_pdsch(grid, req.pdsch[0], data.tb_bits[0], req.slot, "cpu")
    assert (grid[:, 2, 1::2] == 0).all() and (np.abs(grid[:, 2, 0::2]) > 0).mean() > 0.4
    assert (grid[:, :2] == 0).all()
    grid[:] = 0
    ref_dl.map_pdcch(grid, req.pdcch[0], req.slot)
    assert (np.abs(grid[0, 1]) > 0).sum() == 4 * 6 * 12 and (grid[1:] == 0).all()
    blk = ref_dl.ssb_block(req.ssb[0])
    assert set(np.unique(blk[0, 56:183].real)) == {-1.0, 1.0}
    assert set(np.unique(blk[2, 56:183].real)) == {-1.0, 1.0}
    grid[:] = 0
    ref_dl.map_csi_rs(grid, req.csi_rs[0], req.slot)
    assert np.flatnonzero(grid[0, 13]).tolist() == list(range(3, 288, 12))
