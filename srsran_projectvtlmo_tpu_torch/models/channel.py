"""Frequency-domain fading channel emulator (TDL-A/B/C inspired) + AWGN.

A copy of `srsran_projectvtlmo_tpu.models.channel` (numpy, but its package
`__init__` imports jax); the tests hold `run` and `run_mimo` equal to the
original for the same seed.  The reference's BLER-test channel: per rx
port, the slot-constant frequency response is a sum of taps with fixed
delays/powers and Rayleigh random coefficients; AWGN is added at the
configured SINR.
reference: tests/integrationtests/phy/upper/channel_processors/
pxsch_bler_test_channel_emulator.cpp:38-160.
"""

from __future__ import annotations

import numpy as np

#: (delay_ns, power_dB) pairs: profiles inspired by 3GPP TR 38.901 TDL-A/B/C.
TDL_PROFILES = {
    "TDLA": [(0, -15.5), (10, 0.0), (15, -5.1), (20, -5.1), (25, -9.6), (50, -8.2),
             (65, -13.1), (75, -11.5), (105, -11.0), (135, -16.2), (150, -16.6), (290, -26.2)],
    "TDLB": [(0, 0.0), (10, -2.2), (20, -0.6), (30, -0.6), (35, -0.3), (45, -1.2),
             (55, -5.9), (120, -2.2), (170, -0.8), (245, -6.3), (330, -7.5), (480, -7.1)],
    "TDLC": [(0, -6.9), (65, 0.0), (70, -7.7), (190, -2.5), (195, -2.4), (200, -9.9),
             (240, -8.0), (325, -6.6), (520, -7.1), (1045, -13.0), (1510, -14.2), (2595, -16.0)],
}


class ChannelEmulator:
    """Applies a random slot-constant frequency-selective channel + AWGN to a grid.

    Host-side numpy (test harness component, like the reference's emulator).
    """

    def __init__(self, profile: str, sinr_db: float, nof_rx_ports: int, nof_subc: int,
                 scs_hz: float, seed: int = 0):
        if profile == "AWGN":
            taps = [(0, 0.0)]
            self.fading = False
        else:
            taps = TDL_PROFILES[profile]
            self.fading = True
        self.rng = np.random.default_rng(seed)
        self.nof_rx_ports = nof_rx_ports
        self.nof_subc = nof_subc
        self.noise_amp = 10.0 ** (-sinr_db / 20.0)

        delays = np.array([t[0] for t in taps]) * 1e-9
        powers = 10.0 ** (np.array([t[1] for t in taps]) / 10.0)
        norm = 1.0 / np.sqrt(nof_rx_ports * powers.sum())
        amps = norm * np.sqrt(powers)
        n = 1 + np.arange(nof_subc)
        # Per-tap frequency response over the grid subcarriers.
        self.tap_response = amps[:, None] * np.exp(
            -2j * np.pi * n[None, :] * (delays[:, None] * scs_hz)
        )  # (ntaps, nsubc)

    def freq_response(self) -> np.ndarray:
        """Draw a random channel: (nof_rx_ports, nsubc) complex64."""
        ntaps = self.tap_response.shape[0]
        if not self.fading:
            coefs = np.ones((self.nof_rx_ports, ntaps), np.complex64)
        else:
            coefs = (self.rng.normal(size=(self.nof_rx_ports, ntaps))
                     + 1j * self.rng.normal(size=(self.nof_rx_ports, ntaps))) / np.sqrt(2)
        return (coefs @ self.tap_response).astype(np.complex64)

    def run(self, tx_grid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """tx_grid (nsym, nsubc) complex -> (rx_grid (nports, nsym, nsubc), h (nports, nsubc)).

        The channel is constant over the slot's symbols; AWGN is per-RE.
        """
        h = self.freq_response()
        rx = h[:, None, :] * tx_grid[None, :, :]
        noise = (self.rng.normal(size=rx.shape) + 1j * self.rng.normal(size=rx.shape)) / np.sqrt(2)
        rx = rx + self.noise_amp * noise
        return rx.astype(np.complex64), h

    def run_mimo(self, tx_grids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """tx_grids (nlayers, nsym, nsubc) -> (rx (nports, nsym, nsubc),
        h (nports, nlayers, nsubc)); independent fading per (port, layer)."""
        nlayers = tx_grids.shape[0]
        h = np.stack([self.freq_response() for _ in range(nlayers)], axis=1)
        rx = np.einsum("plk,lsk->psk", h, tx_grids)
        noise = (self.rng.normal(size=rx.shape) + 1j * self.rng.normal(size=rx.shape)) / np.sqrt(2)
        rx = rx + self.noise_amp * noise
        return rx.astype(np.complex64), h
