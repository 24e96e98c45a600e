"""Lower-PHY host pipeline: amplitude control and the baseband slot loop
(port of `srsran_projectvtlmo_tpu.phy.lower`).

The reference runs self-re-enqueueing DL/UL task chains on dedicated executors
feeding a radio gateway (reference: lib/phy/lower/lower_phy_baseband_processor.cpp:78-196);
here the sample clock is simulated or externally fed, so the lower PHY is a
host loop that drives the upper PHY's slot programs and moves samples
through a baseband gateway (radio/).

The amplitude controller mirrors the reference's gain + hard-clipping stage
with clipping metrics (reference: lib/phy/lower/amplitude_controller/
amplitude_controller_clipping_impl.cpp).  It runs on the samples' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AmplitudeControllerMetrics:
    avg_power: float
    peak_power: float
    clipped_ratio: float

    @property
    def papr_db(self) -> float:
        if self.avg_power <= 0:
            return 0.0
        return 10.0 * np.log10(self.peak_power / self.avg_power)


class AmplitudeController:
    """Gain + optional hard clipping at the full-scale ceiling."""

    def __init__(self, gain_db: float = 0.0, full_scale: float = 1.0, enable_clipping: bool = True):
        self.gain = 10.0 ** (gain_db / 20.0)
        self.full_scale = full_scale
        self.enable_clipping = enable_clipping

    @torch.no_grad()
    def process(self, samples_pair) -> tuple[torch.Tensor, AmplitudeControllerMetrics]:
        """(..., 2) real-pair samples (a tensor, or a host array) -> (the
        scaled and clipped samples as float32 on the same device, metrics).
        The metrics come back to the host as floats: this waits for the
        device."""
        x = torch.as_tensor(samples_pair, dtype=torch.float32) * self.gain
        power = (x * x).sum(-1)
        nclipped = torch.zeros((), device=x.device)
        if self.enable_clipping:
            mag = torch.sqrt(torch.clamp(power, min=1e-30))
            over = mag > self.full_scale
            nclipped = over.sum()
            x = x * torch.where(over, self.full_scale / mag, torch.ones_like(mag))[..., None]
        # One copy to the host for the three metrics.
        avg, peak, nclipped = torch.stack([power.mean().double(), power.amax().double(),
                                           nclipped.double()]).tolist()
        return x, AmplitudeControllerMetrics(avg, peak, nclipped / power.numel())


class LowerPhy:
    """Slot-clocked DL/UL baseband pipeline over a baseband gateway."""

    def __init__(self, upper_phy, gateway, amplitude: AmplitudeController | None = None):
        self.upper = upper_phy
        self.gateway = gateway
        self.amplitude = amplitude or AmplitudeController()

    def run_dl_slot(self, dl_request, tx_data=None):
        # The samples stay on the upper PHY's device for amplitude control;
        # only its output crosses to the host gateway.
        _, samples = self.upper.process_dl_slot(dl_request, tx_data, fetch=False)
        out, metrics = self.amplitude.process(samples)
        self.gateway.transmit(out.cpu().numpy())
        return metrics

    def run_ul_slot(self, ul_request, nof_samples: int, prach_samples=None):
        samples = self.gateway.receive(nof_samples)
        return self.upper.process_ul_slot(ul_request, samples, prach_samples)
