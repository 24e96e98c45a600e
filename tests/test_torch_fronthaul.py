"""PyTorch port, the split-7.2 fronthaul against the JAX package: BFP and
'none' IQ compression with the PRB packer (`ops/ofh_compression`), the
U-plane / C-plane / eCPRI / VLAN framing and the receive checkers (`ofh/*`),
and slot-point arithmetic (`ran/slot`).

The cases of tests/test_ofh_compression.py and tests/test_ofh_loop.py run
through both packages on the same seeded numpy inputs.  Everything here is
integer or bit-exact in the JAX package and is held equal: mantissas,
exponents, wire bytes, frames, and the floats of decompression (an integer
shifted, converted and multiplied by one float32 reciprocal, as XLA compiles
the JAX division by a constant: the same IEEE operations).
The one tolerance is the loop's own: the grid back through 9-bit BFP within
1% EVM, as tests/test_ofh_loop.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.ofh import cplane as jax_cplane
from srsran_projectvtlmo_tpu.ofh import ecpri as jax_ecpri
from srsran_projectvtlmo_tpu.ofh import ethernet as jax_ethernet
from srsran_projectvtlmo_tpu.ofh import uplane as jax_uplane
from srsran_projectvtlmo_tpu.ofh.reception import SequenceIdChecker as JaxSeqChecker
from srsran_projectvtlmo_tpu.ops import ofh_compression as jax_ofh
from srsran_projectvtlmo_tpu.ran.slot import SlotPoint as JaxSlotPoint

from srsran_projectvtlmo_tpu_torch.ofh import cplane, ecpri, ethernet, uplane
from srsran_projectvtlmo_tpu_torch.ofh.reception import RxWindowChecker, SequenceIdChecker
from srsran_projectvtlmo_tpu_torch.ops import ofh_compression as ofh
from srsran_projectvtlmo_tpu_torch.ran.slot import SlotPoint


def _rand_iq(rng, shape, scale=0.7):
    """tests/test_ofh_compression.py's input: (..., n_prb, 12, 2) float32."""
    return (rng.normal(size=shape + (12, 2)) * scale / 3).clip(-1, 1).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("width", [8, 9, 12, 14, 16])
def test_bfp_compress_equals_jax_and_golden(width):
    """Mantissas and exponents bit-exact against JAX and the scalar golden
    model, on tests/test_ofh_compression.py's input and one driven into
    clipping."""
    rng = np.random.default_rng(width)
    for iq in (_rand_iq(rng, (24,)), _rand_iq(rng, (50,), scale=3.0)):
        mant, exp = ofh.bfp_compress(torch.as_tensor(iq), width)
        jm, je = jax_ofh.bfp_compress(iq, width)
        assert mant.dtype == torch.int32 and exp.dtype == torch.int32
        np.testing.assert_array_equal(mant.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(exp.numpy(), np.asarray(je))
        q = np.clip(np.round(iq * 32767.0), -32768, 32767).astype(np.int64)
        for p in range(iq.shape[0]):
            g_m, g_e = ofh.golden_bfp_compress_prb(q[p].reshape(24), width)
            assert (g_m == jax_ofh.golden_bfp_compress_prb(q[p].reshape(24), width)[0]).all()
            assert exp[p] == g_e
            np.testing.assert_array_equal(mant[p].numpy(), g_m)
        assert mant.max() <= (1 << (width - 1)) - 1 and mant.min() >= -(1 << (width - 1))


def test_quantizer_rounds_half_to_even():
    """With the gain scaled to 1 the quantizer sees exact halves: round half
    to even, as jnp.round; and |min| - 1 decides the exponent of a PRB whose
    extreme is -2^(k)."""
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -32768.0, 32767.4, 40000.0],
                    np.float32)
    iq = np.zeros((2, 12, 2), np.float32)
    iq[0].reshape(-1)[:len(vals)] = vals
    iq[1].reshape(-1)[:2] = [-256.0, 255.0]
    scaling = 1.0 / 32767.0
    for width in (8, 9):
        got = ofh.bfp_compress(torch.as_tensor(iq), width, scaling)
        want = jax_ofh.bfp_compress(iq, width, scaling)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q = ofh.none_compress(torch.as_tensor(iq), scaling)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_ofh.none_compress(iq, scaling)))
    assert q[0, :len(vals)].tolist() == [0, 2, 2, 0, -2, -2, 4, -32768, 32767, 32767]


@pytest.mark.parametrize("width", [8, 9, 12, 14, 16])
def test_pack_unpack_equal_jax(width):
    """Wire bytes, unpacked mantissas and exponents, and decompressed floats
    bit-exact against JAX, with and without the exponent byte."""
    rng = np.random.default_rng(width + 100)
    iq = _rand_iq(rng, (3, 16))
    mant, exp = ofh.bfp_compress(torch.as_tensor(iq), width)
    wire = ofh.pack_prbs(mant, width, exp)
    jwire = np.asarray(jax_ofh.pack_prbs(np.asarray(mant), width, np.asarray(exp)))
    assert wire.dtype == torch.uint8 and wire.shape == (3, 16, 1 + (24 * width + 7) // 8)
    np.testing.assert_array_equal(wire.numpy(), jwire)
    np.testing.assert_array_equal(ofh.pack_prbs(mant, width).numpy(),
                                  np.asarray(jax_ofh.pack_prbs(np.asarray(mant), width)))
    m2, e2 = ofh.unpack_prbs(wire, width, True)
    np.testing.assert_array_equal(m2.numpy(), mant.numpy())
    np.testing.assert_array_equal(e2.numpy(), exp.numpy())
    rec = ofh.bfp_decompress(m2, width, 0.5, exponents=e2)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(jax_ofh.bfp_decompress(np.asarray(m2), width, 0.5,
                                                       exponents=np.asarray(e2))))
    m3, e3 = ofh.unpack_prbs(wire[..., 1:], width, False)
    assert e3 is None
    np.testing.assert_array_equal(m3.numpy(), mant.numpy())


@pytest.mark.parametrize("kind,width,min_snr_db", [("bfp", 9, 40.0), ("bfp", 14, 70.0),
                                                   ("none", 16, 80.0)])
def test_symbol_compression_equal_jax(kind, width, min_snr_db):
    """compress_symbol / decompress_symbol bytes and floats equal to JAX,
    and the reconstruction SNR of tests/test_ofh_compression.py."""
    iq = _rand_iq(np.random.default_rng(7), (64,))
    wire = ofh.compress_symbol(torch.as_tensor(iq), kind, width)
    np.testing.assert_array_equal(wire.numpy(),
                                  np.asarray(jax_ofh.compress_symbol(iq, kind, width)))
    out = ofh.decompress_symbol(wire, kind, width).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_ofh.decompress_symbol(wire.numpy(), kind,
                                                                            width)))
    snr = 10 * np.log10(np.sum(iq ** 2) / max(np.sum((out - iq) ** 2), 1e-30))
    assert snr > min_snr_db
    with pytest.raises(ValueError):
        ofh.compress_symbol(torch.as_tensor(iq), "mu-law", width)


def test_none_compression_equal_jax():
    iq = _rand_iq(np.random.default_rng(3), (2, 14, 10), scale=2.0)
    got = ofh.none_compress(torch.as_tensor(iq), 0.7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ofh.none_compress(iq, 0.7)))
    np.testing.assert_array_equal(ofh.none_decompress(got, 0.7).numpy(),
                                  np.asarray(jax_ofh.none_decompress(got.numpy(), 0.7)))
    mant, exp = ofh.bfp_compress(torch.as_tensor(iq), 9)
    assert mant.shape == (2, 14, 10, 24) and exp.shape == (2, 14, 10)
    assert ofh.bfp_decompress(mant, 9, exponents=exp).shape == iq.shape


def test_slot_point_equal_jax():
    for mu in range(5):
        for count in (0, 19, 43, 10239, 1024 * 10 * (1 << mu) + 5, -3):
            a, b = SlotPoint(mu, count), JaxSlotPoint(mu, count)
            for f in ("count", "sfn", "slot_index", "subframe_index", "slot_in_subframe",
                      "slots_per_frame", "nof_slots_per_hyperframe"):
                assert getattr(a, f) == getattr(b, f), (mu, count, f)
            for n in (1, 7, 1024 * 20 - 1):
                assert (a + n).count == (b + n).count
                assert (a + n) - a == (b + n) - b
                assert ((a + n) < a) == ((b + n) < b)


# ---------------------------------------------------- the OFH data loop --

VLAN = dict(mac_dst=b"\x02\x00\x00\x00\x00\x01", mac_src=b"\x02\x00\x00\x00\x00\x02", tci=3)


def _du_frames(grid, nof_rb, slot_count, width, mods):
    """tests/test_ofh_loop.py's DU side with the modules `mods` (the port's
    or the JAX package's): one slot of IQ as per-symbol VLAN frames."""
    comp, cp, ec, eth, up, slot_cls = mods
    vlan = eth.VlanFrameParams(**VLAN)
    pt = slot_cls(numerology=1, count=slot_count)
    hdr = cp.CplaneRadioHeader(direction=1, sfn=pt.sfn, subframe=pt.subframe_index,
                               slot=pt.slot_in_subframe, start_symbol=0)
    sec = cp.CplaneCommonSection(section_id=0, prb_start=0, nof_prb=nof_rb, nof_symbols=14)
    frames = [("cplane", eth.build_vlan_frame(vlan, ec.build_rt_control_packet(
        rtc_id=0, seq_id=0, payload=cp.build_type1_message(hdr, sec))))]
    for sym in range(14):
        re_pair = np.stack([grid[sym].real, grid[sym].imag], -1).reshape(nof_rb, 12, 2)
        mant, exp = comp.bfp_compress(re_pair[None].astype(np.float32), width, iq_scaling=0.5)
        prb_bytes = _np(comp.pack_prbs(mant, width, exp))[0]
        params = up.UplaneMessageParams(slot=pt, symbol_id=sym, start_prb=0, nof_prb=nof_rb,
                                        data_width=width)
        pkt = ec.build_iq_data_packet(pc_id=0, seq_id=sym & 0xFF,
                                      payload=up.build_uplane_message(params, prb_bytes))
        frames.append(("uplane", eth.build_vlan_frame(vlan, pkt)))
    return frames


def _port_du_frames(grid, nof_rb, slot_count, width):
    return _du_frames(grid, nof_rb, slot_count, width, (_PortComp, cplane, ecpri, ethernet,
                                                        uplane, SlotPoint))


class _PortComp:
    """The port's compression on a host array: a CPU tensor in, as the app
    hands it a slot's grid."""

    @staticmethod
    def bfp_compress(x, width, iq_scaling):
        return ofh.bfp_compress(torch.as_tensor(x), width, iq_scaling)

    pack_prbs = staticmethod(ofh.pack_prbs)


def _ru_receive(frames, nof_rb, width):
    """The port's RU side: frames back through the checkers to the grid."""
    seq = SequenceIdChecker()
    win = RxWindowChecker(numerology=1, sym_start=0, sym_end=28)
    grid = np.zeros((14, nof_rb * 12), np.complex64)
    lost = 0
    got_cplane = None
    for kind, frame in frames:
        pkt = ecpri.decode_packet(ethernet.decode_vlan_frame(frame).payload)
        if kind == "cplane":
            got_cplane = cplane.decode_message(pkt.payload)
            continue
        lost += abs(seq.update_and_compare(pkt.pc_id, pkt.seq_id))
        res = uplane.decode_uplane_message(pkt.payload, static_width=width)
        slot_index = res.slot_id + 2 * res.subframe_id
        win.on_new_symbol(res.frame_id, slot_index, res.symbol_id)
        assert win.check(res.frame_id, slot_index, res.symbol_id) == "on_time"
        mant, exp = ofh.unpack_prbs(torch.as_tensor(res.prb_payload.copy()), width)
        vals = ofh.bfp_decompress(mant, width, iq_scaling=0.5, exponents=exp).numpy()
        grid[res.symbol_id, res.start_prb * 12:(res.start_prb + res.nof_prb) * 12] = \
            (vals[..., 0] + 1j * vals[..., 1]).reshape(-1)
    return grid, lost, got_cplane


def test_ofh_loop_frames_equal_jax():
    """A seeded grid (12 PRB, values past the quantizer's range included)
    through both packages' DU chains: byte-identical frames; the JAX RU side
    and the port's see the same sequence ids, and a dropped frame is
    counted as lost by both."""
    rng = np.random.default_rng(1)
    grid = (rng.normal(size=(14, 144)) + 1j * rng.normal(size=(14, 144))).astype(np.complex64)
    ours = _port_du_frames(grid, 12, 1, 9)
    theirs = _du_frames(grid, 12, 1, 9, (jax_ofh, jax_cplane, jax_ecpri, jax_ethernet,
                                         jax_uplane, JaxSlotPoint))
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    assert [f for _, f in ours] == [f for _, f in theirs]
    dropped = [f for i, f in enumerate(ours) if i != 5]
    _, lost, _ = _ru_receive(dropped, 12, 9)
    jseq = JaxSeqChecker()
    jlost = sum(abs(jseq.update_and_compare(p.pc_id, p.seq_id)) for p in (
        jax_ecpri.decode_packet(jax_ethernet.decode_vlan_frame(f).payload)
        for k, f in dropped if k == "uplane"))
    assert lost == jlost == 1


def test_dl_slot_through_the_ports_fronthaul():
    """The port's own 24-PRB DL slot (QAM64 PDSCH, tests/test_ofh_loop.py's
    slot) through the port's chain: no frame lost, the C-plane message back,
    the grid within 1% EVM and silent REs exactly zero."""
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import DlTtiRequest, PdschPdu, TxDataRequest
    from srsran_projectvtlmo_tpu_torch.phy.dl_slot import get_dl_slot_program
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
    from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation

    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1)
    pdu = PdschPdu(rnti=0x77, rb_start=0, rb_size=24, modulation=Modulation.QAM64,
                   target_code_rate=0.6, start_symbol=1, nof_symbols=13, dmrs_symbols=(2,),
                   n_id=cell.phys_cell_id)
    req = DlTtiRequest(slot=5, pdsch=(pdu,))
    tbs = get_dl_slot_program(req, cell, "cpu").pdsch_cfgs[0].tbs
    tb = np.random.default_rng(0).integers(0, 2, tbs).astype(np.uint8)
    grid, _ = UpperPhy(cell, device="cpu").process_dl_slot(req, TxDataRequest(5, [tb]))
    frames = _port_du_frames(grid, 24, 5, 9)
    rebuilt, lost, cp = _ru_receive(frames, 24, 9)
    assert lost == 0
    assert cp is not None and cp.section.nof_prb == 24
    err = np.linalg.norm(rebuilt - grid) / np.linalg.norm(grid)
    assert err < 0.01, f"fronthaul EVM {err:.4f}"
    assert np.abs(rebuilt[0]).max() == 0 and np.abs(grid[0]).max() == 0
    _, lost, _ = _ru_receive([f for i, f in enumerate(frames) if i != 5], 24, 9)
    assert lost >= 1


def test_cplane_and_ethernet_equal_jax():
    """Type 0/1/3 C-plane messages, VLAN frames and eAxC ids byte for byte."""
    hdr = dict(direction=0, sfn=77, subframe=3, slot=1, start_symbol=4, filter_index=1)
    sec = dict(section_id=0x123, prb_start=300, nof_prb=273, re_mask=0xABC, nof_symbols=2)
    p3 = dict(time_offset=0x1234, frame_structure_fft=11, scs_hz=1.25e3, cp_length=99,
              freq_offset=-513)
    for mod, jmod in ((cplane, jax_cplane),):
        h, s = mod.CplaneRadioHeader(**hdr), mod.CplaneCommonSection(**sec)
        jh, js = jmod.CplaneRadioHeader(**hdr), jmod.CplaneCommonSection(**sec)
        msgs = [mod.build_type1_message(h, s, 0x91), mod.build_type0_message(h, s, 5, 6, 7),
                mod.build_type3_message(h, s, mod.CplaneSection3Params(**p3), 0x91)]
        jmsgs = [jmod.build_type1_message(jh, js, 0x91), jmod.build_type0_message(jh, js, 5, 6, 7),
                 jmod.build_type3_message(jh, js, jmod.CplaneSection3Params(**p3), 0x91)]
        assert msgs == jmsgs
        for m, jm in zip(msgs, jmsgs):
            assert dataclasses.asdict(mod.decode_message(m)) == \
                dataclasses.asdict(jmod.decode_message(jm))
    frame = ethernet.build_vlan_frame(ethernet.VlanFrameParams(**VLAN), b"\x01" * 10)
    assert frame == jax_ethernet.build_vlan_frame(jax_ethernet.VlanFrameParams(**VLAN),
                                                  b"\x01" * 10)
    assert dataclasses.asdict(ethernet.decode_vlan_frame(frame)) == \
        dataclasses.asdict(jax_ethernet.decode_vlan_frame(frame))
    for ids in ((0, 0, 0, 0), (3, 63, 15, 15), (1, 5, 2, 9)):
        pc = ethernet.eaxc_pc_id(*ids)
        assert pc == jax_ethernet.eaxc_pc_id(*ids) and ethernet.eaxc_unpack(pc) == ids
