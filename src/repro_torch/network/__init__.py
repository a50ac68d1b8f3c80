"""Satellite-network simulation (copies of ``repro.network``): orbits,
link model, window-aware transmission scheduling."""
from repro_torch.network.orbit import ContactPlan, contact_fraction, orbital_period_s  # noqa: F401
from repro_torch.network.link import LinkModel  # noqa: F401
from repro_torch.network.scheduler import TransmissionScheduler, fleet_expected_latency  # noqa: F401
