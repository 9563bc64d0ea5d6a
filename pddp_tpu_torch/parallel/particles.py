"""Particle-axis sharding: one solve's BNN ensemble spread over ranks (port
of ``pddp_tpu/parallel/particles.py``).

Every rank pushes its block of the particles through the (replicated)
network, and only the moment match's statistics, the ensemble mean and
covariance, are summed over the ranks: two all-reduces a dynamics step
(``utils.particles.moment_match``), and one for the noise inference's
fallback flag. The rest of the solve (the cost, K1, the status machine)
runs on every rank on the same, replicated values, so every rank returns
the same result. The Jacobians are the model's structured ones: the
all-reduce carries its tangents (``parallel.collectives``).

On a 2-D ``dp`` x ``pp`` mesh (``particle_sharded_batched_solve``) the
batch shards over ``dp`` and each solve's particles over ``pp``, whose
ranks alone sum the statistics.
"""

from __future__ import annotations

from ..controllers.ilqr import ILQROptions, solve, solve_lanes
from ..encoding import StateEncoding
from . import collectives
from .batch import _block, _gather_results

__all__ = [
    "particle_partition_specs",
    "particle_sharded_solve",
    "particle_sharded_batched_solve",
]

#: Leaves that carry the particle axis, by field name, and the axis: the
#: episode noise is (horizon, n_particles, state_size), each dropout's
#: noise (n_particles, width).
_PARTICLE_LEAVES = {"eps_in": 1, "eps_out": 1, "noise": 0}

#: the model's tensor fields besides the net.
_MODEL_FIELDS = ("X_mean", "X_std", "dX_mean", "dX_std", "eps_out", "eps_in",
                 "u_min", "u_max")


def particle_partition_specs(model, axis_name: str = "pp"):
    """The dim of each tensor leaf of a BNN dynamics model along which
    ``axis_name`` shards the particles: a dict from the leaf's path
    (``"eps_in"``, ``"net.layers.0.W"``, ``"net.dropouts.0.noise"``, ...)
    to the dim, or None for the leaves every rank holds whole (weights
    and normalization buffers). ``pddp_tpu`` returns the same as
    ``PartitionSpec``s over ``axis_name``."""
    del axis_name  # every particle leaf shards over the one axis
    paths = [k for k in _MODEL_FIELDS if getattr(model, k, None) is not None]
    for kind in ("layers", "dropouts"):
        for i, part in enumerate(getattr(model.net, kind)):
            if part is not None:
                paths += ["net.{}.{}.{}".format(kind, i, f)
                          for f in part.FIELDS]
    return {p: _PARTICLE_LEAVES.get(p.rsplit(".", 1)[-1]) for p in paths}


def _check_divisible(model, group, axis_name):
    size = collectives.group_size(group)
    if model.n_particles % size:
        raise ValueError(
            "n_particles {} not divisible by mesh axis {!r} of size {}"
            .format(model.n_particles, axis_name, size))


def _local_ensemble(model, group):
    """This rank's view of ``model``: its contiguous block of the
    particles (``particle_partition_specs``' dims), the moment match
    summed over ``group``."""
    size, rank = collectives.group_size(group), collectives.group_rank(group)
    n = model.n_particles // size

    def block(t, dim):
        return t.narrow(dim, rank * n, n)

    specs = particle_partition_specs(model)
    drops = [None if d is None else d._with_noise(block(
        d.noise, specs["net.dropouts.{}.noise".format(i)]))
        for i, d in enumerate(model.net.dropouts)]
    fields = {k: block(getattr(model, k), specs[k]) for k in _MODEL_FIELDS
              if specs.get(k) is not None}
    return model.replace(net=model.net._like(model.net.layers, drops),
                         n_particles=n, n_particles_global=model.n_particles,
                         particle_group=group, **fields)


def particle_sharded_solve(model, cost, z0, U0, opts: ILQROptions,
                           encoding: StateEncoding = StateEncoding.DEFAULT,
                           mesh=None, axis_name: str = "pp"):
    """One iLQR/PDDP solve with the BNN particle ensemble sharded over the
    mesh's ``axis_name`` ranks, each rank holding its contiguous block of
    the particles. Every rank passes the whole model and gets the same
    ``ILQRResult`` as ``solve``'s."""
    group = mesh.get_group(axis_name)
    _check_divisible(model, group, axis_name)
    return solve(_local_ensemble(model, group), cost, z0, U0, opts,
                 encoding=encoding)


def particle_sharded_batched_solve(model, cost, z0s, U0s, opts: ILQROptions,
                                   encoding: StateEncoding =
                                   StateEncoding.DEFAULT,
                                   mesh=None, batch_axis: str = "dp",
                                   particle_axis: str = "pp"):
    """B independent solves on a 2-D mesh: the batch shards over
    ``batch_axis`` (each rank its contiguous B / size lanes, no
    communication), each solve's ensemble over ``particle_axis`` (the
    moment match's sums over that axis's ranks only).

    z0s: (B, nz), U0s: (B, N, nu); B must divide by the batch axis size.
    Every rank passes the whole batch and returns the whole batch's
    ``ILQRResult`` (``solve_lanes``'), gathered over ``batch_axis``.
    """
    pgroup = mesh.get_group(particle_axis)
    _check_divisible(model, pgroup, particle_axis)
    bgroup = mesh.get_group(batch_axis)
    B, n_b = z0s.shape[0], collectives.group_size(bgroup)
    if B % n_b:
        raise ValueError("batch {} not divisible by mesh axis {!r} of "
                         "size {}".format(B, batch_axis, n_b))
    out = solve_lanes(_local_ensemble(model, pgroup), cost,
                      _block(z0s, bgroup), _block(U0s, bgroup), opts,
                      encoding=encoding)
    return _gather_results(out, bgroup)
