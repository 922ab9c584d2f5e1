"""One gloo rank of the sharded-fleet tests (tests/test_torch_fleet_sharded.py).

    python tests/torch_fleet_rank.py RANK WORLD DIR

Reads DIR/job.pt (written by the test), joins the process group through
the file store DIR/store, and writes DIR/rank{RANK}.pt: per backend the
rank's own robots after the job's steps, the whole fleet read back with
`gather_robots` and `fleet_health(group=...)`; the health of the job's
`health_states`; one more step with and without `fleet_reinit_masked`;
and which misuses raised. Imports torch and the port only.
"""

import sys

import torch

from badger_amcl_tpu_torch import fleet
from badger_amcl_tpu_torch.pf.types import map_tensors


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(f"{root}/job.pt", weights_only=False)
    group = fleet.init_fleet_group(f"file://{root}/store", world, rank, device="cpu")
    try:
        out = {}

        def shard(x):
            return fleet.shard_robots(x, group)

        omap, sp, params, alphas = job["omap"], job["sp"], job["params"], job["alphas"]
        r = job["states"].poses.shape[0]
        fixed = [shard(job[k]) for k in ("scans", "pools", "odom_poses", "deltas")]

        def stepper(backend):
            step = fleet.make_sharded_fleet_step(group, params, backend=backend, device="cpu",
                                                 n_robots=r)
            return lambda s, noise: step(s, omap, sp, *fixed, fixed[-1], alphas,
                                         noise=shard(noise))

        for backend in ("exact", "corr"):
            step = stepper(backend)
            s = shard(job["states"])
            for noise in job["noises"]:
                s = step(s, noise)
            out[backend] = dict(own=s, whole=fleet.gather_robots(s, group),
                                health=fleet.fleet_health(s, group))
        out["health_jax_states"] = fleet.fleet_health(shard(job["health_states"]), group)

        # the reinit on a shard: one more step with and without it
        step = stepper("corr")
        s = out["corr"]["own"]
        re = fleet.fleet_reinit_masked(s, shard(job["mask"]), shard(job["pose_pools"]), params)
        out["reinit"] = dict(without=step(s, job["extra_noise"]),
                             with_=step(re, job["extra_noise"]))

        def one(x):  # the first robot alone, where r / world are due
            return map_tensors(lambda t: t[:1], x)

        out["raises"] = dict(
            shard_3_robots=_raises(lambda: fleet.shard_robots(torch.zeros(3, 2), group)),
            n_robots_3=_raises(lambda: fleet.make_sharded_fleet_step(
                group, params, device="cpu", n_robots=3)),
            backend_lf=_raises(lambda: fleet.make_sharded_fleet_step(
                group, params, backend="lf", device="cpu", n_robots=r)),
            wrong_count=_raises(lambda: fleet.make_sharded_fleet_step(
                group, params, device="cpu", n_robots=r)(
                    one(shard(job["states"])), omap, sp, *[one(x) for x in fixed],
                    one(fixed[-1]), alphas, generator=torch.Generator().manual_seed(0))),
            off_device=_raises(lambda: fleet.make_sharded_fleet_step(
                group, params, device="cuda:0", n_robots=r)(
                    shard(job["states"]), omap, sp, *fixed, fixed[-1], alphas,
                    generator=torch.Generator().manual_seed(0))),
        )
        torch.save(out, f"{root}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
