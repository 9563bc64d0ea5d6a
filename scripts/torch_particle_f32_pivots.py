#!/usr/bin/env python3
"""Where the float32 local model of chip_smoke.py's Cholesky particle
cartpole row (phase 17: P=100, N=50, numpy seeds 17 and 18) goes
non-finite, on the CPU and on a CUDA device.

    python3 scripts/torch_particle_f32_pivots.py [cpu] [cuda]

For each device (both by default), the float32 rollout of U0 and, at
steps 3-5, the pivots of the unrolled Cholesky (``utils.linalg.
small_cholesky``'s order) of the cost's augmented covariance (the
cartpole's [x, x', theta', sin, cos] moments, ``utils.angular.
_augment_covar``) plus each jitter of ``JITTER_LEVELS``: a negative
pivot makes that rung's factor NaN. Then the steps where the local
model's L_z is not finite, on the device's own rollout and, with both
devices, on the other device's. Prints one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

STEPS = (3, 4, 5)


def pivots(C):
    """The diagonal pivots of the Cholesky-Crout recursion of C (n x n),
    before their square roots."""
    import torch
    n = C.shape[-1]
    L = [[None] * n for _ in range(n)]
    out = []
    for i in range(n):
        for j in range(i + 1):
            s = C[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                out.append(float(s))
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return out


def nonfinite_steps(t):
    import torch
    return (~torch.isfinite(t).reshape(t.shape[0], -1).all(-1)).nonzero() \
        .flatten().tolist()


def main():
    import torch
    from pddp_tpu_torch.controllers.ilqr import local_model, rollout
    from pddp_tpu_torch.encoding import (StateEncoding, decode_covar,
                                         decode_mean)
    from pddp_tpu_torch.examples.cartpole import CartpoleDynamicsModel
    from pddp_tpu_torch.utils.angular import _augment_covar
    from pddp_tpu_torch.utils.linalg import JITTER_LEVELS, _sym
    ch, f32 = StateEncoding.UPPER_TRIANGULAR_CHOLESKY, torch.float32
    devices = tuple(sys.argv[1:]) or ("cpu", "cuda")
    L_z = cs.LOCAL_NAMES.index("L_z")
    runs, out = {}, {}
    for dev in devices:
        model, cost, z0, U0 = cs.particle_problem("cartpole_chol", dev, f32)
        Z, AUX = rollout(model, z0, U0, ch)
        runs[dev] = (model, cost, Z, U0, AUX)
        row = {}
        for i in STEPS:
            m, C = decode_mean(Z[i], ch, 4), decode_covar(Z[i], ch, 4)
            _, Ca = _augment_covar(m, C, CartpoleDynamicsModel.angular_indices,
                                   CartpoleDynamicsModel.non_angular_indices)
            Ca = _sym(Ca)
            eye = torch.eye(Ca.shape[-1], dtype=f32, device=Ca.device)
            row["step_{}_pivots_per_jitter".format(i)] = {
                str(j): pivots(Ca + j * eye) for j in JITTER_LEVELS}
        row["L_z_nonfinite_steps"] = nonfinite_steps(
            local_model(Z, U0, AUX, model, cost, ch)[L_z])
        out[dev] = row
    if len(devices) == 2:
        for dev, other in (devices, devices[::-1]):
            model, cost, _, U0, _ = runs[dev]
            _, _, Z, _, AUX = runs[other]
            out["{}_on_{}_rollout".format(dev, other)] = nonfinite_steps(
                local_model(Z.to(dev), U0, AUX.to(dev), model, cost, ch)[L_z])
    if "cuda" in devices:
        out["card"] = cs.card_line()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
