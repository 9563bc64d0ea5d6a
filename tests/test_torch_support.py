"""The port's support modules against pddp_tpu, on the CPU.

``GymEnv`` against pddp_tpu's on seeded gymnasium ``Pendulum-v1`` and
``CartPole-v1`` (the same observations, states and clamped actions; these
skip without gymnasium); ``utils.checkpoint``: ``save_state_dict`` /
``load_state_dict`` across both packages in both directions on an
``iLQRController.state_dict()``, and ``save_pytree`` / ``restore_pytree``
round trips and their leaf-count error; ``utils.profiling`` on the CPU;
``__version__``, ``utils.encoding``'s names and ``utils``' submodules
against pddp_tpu's. Values are compared exactly (float64 data written and
read back, or gymnasium's own arithmetic on equal inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddp_tpu
import pddp_tpu.utils
import pddp_tpu.utils.encoding
from pddp_tpu.controllers.ilqr import iLQRController as JController
from pddp_tpu.envs import gym_env as jg
from pddp_tpu.envs.gym_env import GymEnv as JGymEnv
from pddp_tpu.examples import cartpole as jcp
from pddp_tpu.utils import checkpoint as jckpt
import pddp_tpu_torch
import pddp_tpu_torch.utils
import pddp_tpu_torch.utils.encoding
from pddp_tpu_torch.controllers.ilqr import ILQRResult, iLQRController
from pddp_tpu_torch.envs import GymEnv
from pddp_tpu_torch.envs import gym_env as tg
from pddp_tpu_torch.examples import cartpole as tcp
from pddp_tpu_torch.utils import checkpoint, profiling
from pddp_tpu_torch.utils.constraint import constrain_env
from pddp_tpu_torch.utils.particles import particulate_model

torch.set_num_threads(1)

F64 = {"device": "cpu", "dtype": torch.float64}


def _gym_pair(env_id, seed, cls=GymEnv):
    """Two gymnasium envs seeded alike, wrapped by each package (the
    port's by ``cls``)."""
    gym = pytest.importorskip("gymnasium")
    envs = []
    for _ in range(2):
        e = gym.make(env_id)
        e.reset(seed=seed)
        envs.append(e)
    return JGymEnv(envs[0]), cls(envs[1], **F64)


@pytest.mark.parametrize("env_id, actions", [
    ("Pendulum-v1", [[0.5], [3.0], [-7.0], [1.25]]),
    ("CartPole-v1", [[1.0], [0.2], [-3.0], [0.7]]),
])
def test_gym_env_matches_jax(env_id, actions):
    j_env, t_env = _gym_pair(env_id, seed=4)
    assert (t_env.action_size, t_env.state_size) == (j_env.action_size,
                                                     j_env.state_size)
    for u in actions:
        j_action = jg._action_from_u(np.asarray(u), j_env._action_shape,
                                     j_env._action_dtype, j_env._action_bounds)
        t_action = tg._action_from_u(np.asarray(u), t_env._action_shape,
                                     t_env._action_dtype, t_env._action_bounds)
        assert t_action.dtype == j_action.dtype
        np.testing.assert_array_equal(t_action, j_action)
        j_env.apply(jnp.asarray(u))
        t_env.apply(torch.tensor(u, dtype=torch.float64))
        for var in (1e-2, 0.5):
            js, ts = j_env.get_state(var), t_env.get_state(var)
            np.testing.assert_array_equal(ts.mean().numpy(),
                                          np.asarray(js.mean()))
            np.testing.assert_array_equal(ts.var().numpy(),
                                          np.asarray(js.var()))
    j_env.reset()
    t_env.reset()
    np.testing.assert_array_equal(t_env.get_state().mean().numpy(),
                                  np.asarray(j_env.get_state().mean()))
    t_env.close()
    j_env.close()


def test_constrained_gym_env_squashes_before_the_clamp():
    """``constrain_env(-1, 1)`` on ``GymEnv``: u = 50 squashes to 1.0
    exactly (tanh(50) rounds to 1), what pddp_tpu's plain GymEnv gets."""
    cls = constrain_env(-1.0, 1.0)(GymEnv)
    assert cls.__name__ == "ConstrainedGymEnv"
    j_env, t_env = _gym_pair("Pendulum-v1", 9, cls)
    t_env.apply(torch.tensor([50.0], dtype=torch.float64))
    j_env.apply(np.array([1.0]))
    np.testing.assert_array_equal(t_env.get_state().mean().numpy(),
                                  np.asarray(j_env.get_state().mean()))


def _controllers():
    model = tcp.CartpoleDynamicsModel(dt=0.05, **F64)
    ctrl = iLQRController(tcp.CartpoleEnv(model=model, **F64), model,
                          tcp.CartpoleCost(**F64))
    ctrl.fit(torch.full((6, 1), 0.1, dtype=torch.float64), n_iterations=2)
    j_model = jcp.CartpoleDynamicsModel(dt=0.05)
    j_ctrl = JController(jcp.CartpoleEnv(model=j_model), j_model,
                         jcp.CartpoleCost())
    return ctrl, j_ctrl


def _assert_same_state(t_state, j_state):
    assert set(t_state) == set(j_state)
    for k, v in t_state.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(j_state[k]))


def test_state_dict_files_load_in_both_packages(tmp_path):
    ctrl, j_ctrl = _controllers()
    state = ctrl.state_dict()
    # The port saves, pddp_tpu loads.
    checkpoint.save_state_dict(tmp_path / "port.npz", state)
    j_ctrl.load_state_dict(jckpt.load_state_dict(tmp_path / "port.npz"))
    _assert_same_state({k: v.numpy() for k, v in state.items()},
                       j_ctrl.state_dict())
    # pddp_tpu saves, the port loads.
    j_state = {k: jnp.asarray(np.asarray(v) * 2) for k, v in
               j_ctrl.state_dict().items()}
    jckpt.save_state_dict(tmp_path / "jax.npz", j_state)
    loaded = checkpoint.load_state_dict(tmp_path / "jax.npz", device="cpu")
    assert all(t.device.type == "cpu" for t in loaded.values())
    ctrl.load_state_dict(loaded)
    _assert_same_state({k: v.numpy() for k, v in ctrl.state_dict().items()},
                       j_state)


def test_pytree_round_trip_and_leaf_count(tmp_path):
    inner = tcp.CartpoleDynamicsModel(dt=0.05, **F64)
    model = particulate_model(inner, torch.Generator().manual_seed(0),
                              n_particles=4, horizon=3)
    result = ILQRResult(Z=torch.randn(4, 4, dtype=torch.float64),
                        U=torch.randn(3, 1, dtype=torch.float64),
                        K=torch.randn(3, 1, 4, dtype=torch.float64),
                        J_opt=1.5, state=None, mu=0.0, delta=2.0,
                        iterations=2, evals=3)
    tree = (model, result, {"b": torch.arange(3), "a": [torch.ones(2)]})
    checkpoint.save_pytree(tmp_path / "tree", tree)
    like = (model.replace(eps=torch.zeros_like(model.eps),
                          inner=tcp.CartpoleDynamicsModel(dt=0.2, **F64)),
            ILQRResult(**{**vars(result), "Z": torch.zeros(4, 4),
                          "U": torch.zeros(3, 1, dtype=torch.float64),
                          "K": torch.zeros(3, 1, 4, dtype=torch.float64)}),
            {"a": [torch.zeros(2)], "b": torch.zeros(3, dtype=torch.int64)})
    m, r, d = checkpoint.restore_pytree(tmp_path / "tree", like)
    assert torch.equal(m.eps, model.eps) and torch.equal(m.inner.dt,
                                                         inner.dt)
    assert m.n_particles == 4 and isinstance(m.inner,
                                             tcp.CartpoleDynamicsModel)
    # The template's dtype wins: Z restores as float32.
    assert r.Z.dtype == torch.float32 and torch.equal(r.Z,
                                                      result.Z.float())
    assert torch.equal(r.K, result.K) and r.J_opt == 1.5 and r.evals == 3
    assert torch.equal(d["b"], torch.arange(3)) and torch.equal(
        d["a"][0], torch.ones(2))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_pytree(tmp_path / "tree.npz", like[:2])


def test_phase_timer_and_block_and_time():
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer("a"):
            torch.ones(8).sum()
    with timer("b"):
        pass
    assert dict(timer.counts) == {"a": 3, "b": 1}
    assert all(v >= 0.0 for v in timer.totals.values())
    lines = timer.summary().splitlines()
    assert len(lines) == 2 and lines[0].split()[0] in ("a", "b")
    assert "(x3)" in timer.summary()
    timer.reset()
    assert not timer.totals and not timer.counts
    calls = []
    seconds, out = profiling.block_and_time(lambda x: calls.append(x) or x,
                                            7, n=4, warmup=2)
    assert out == 7 and len(calls) == 6 and seconds >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.ones(4).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert d == str(tmp_path / "tr")


def test_version_and_aliases_match_jax():
    assert pddp_tpu_torch.__version__ == pddp_tpu.__version__ == "0.1.0"
    assert (sorted(pddp_tpu_torch.utils.encoding.__all__)
            == sorted(pddp_tpu.utils.encoding.__all__))
    for name in pddp_tpu_torch.utils.encoding.__all__:
        assert getattr(pddp_tpu_torch.utils.encoding, name) is getattr(
            pddp_tpu_torch.encoding, name)
    left_out = {"autodiff", "classproperty", "compilation_cache"}
    assert set(pddp_tpu.utils.__all__) - left_out <= set(
        pddp_tpu_torch.utils.__all__)
    for name in pddp_tpu_torch.utils.__all__:
        assert getattr(pddp_tpu_torch.utils, name).__name__.endswith(name)
