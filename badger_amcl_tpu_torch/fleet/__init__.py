from badger_amcl_tpu_torch.fleet.fleet import (  # noqa: F401
    FleetNoise,
    FleetScan,
    fleet_health,
    fleet_init,
    fleet_likelihood,
    fleet_reinit_masked,
    fleet_step,
    fleet_window,
)
