"""vnl_tpu_torch.eval_checkpoint (the deterministic evaluation of a saved
policy) against the JAX tool's path (tools/eval_checkpoint.py).

- ``evaluate`` with the keeper policy on the twin's eval env (the whole
  clip from frame 0, root train.build_env's convention), 2 envs and a
  10-step horizon, fed the JAX evaluator's draws (its reset noise from
  ``PRNGKey(7)`` and every step's latent noise), against vnl_tpu's
  ``Evaluator`` with ``make_inference_fn(...)(params, deterministic=True)``
  and ``aggregate_episodes=False``, the port on its unfused stage (like
  with like, as tests/test_torch_cli_eval.py compares): per-episode
  rewards and lengths at rtol/atol 1e-3.  The keeper's episodes end
  early on the twin, so the tally of an episode cut short by ``done`` is
  compared too;
- the same policy read from a params file, a full-state checkpoint,
  ``finished.npz`` and the JAX keeper flattened by
  ``tools/export_torch_assets.py --checkpoint`` gives identical numbers;
- the command line on the CPU prints the JAX tool's lines and its JSON
  line."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import train as jtrain
from tools import export_torch_assets as exporter
from vnl_tpu import envs as jenvs
from vnl_tpu import models as jmodels
from vnl_tpu.training import acting as jacting
from vnl_tpu_torch import compat
from vnl_tpu_torch import eval_checkpoint
from vnl_tpu_torch.training import checkpoint
from vnl_tpu_torch.training.running_statistics import RunningStatisticsState
from vnl_tpu_torch.training.train import TrainingState

import torch_parity as tp
from test_torch_cli import _cfg, clip_pickle  # noqa: F401 (fixture)
from test_torch_cli_eval import keeper_jax

B, STEPS = 2, 10
KEEPER_STATE = os.path.join(tp.ROOT, "checkpoints_keep", "13fcbe84",
                            "state_230809600")


def jax_evaluator_draws(n=B, steps=STEPS, latent=64, nq=74):
    """The draws of vnl_tpu's Evaluator(key=PRNGKey(7)) on its first
    evaluation (acting.py run_evaluation / generate_unroll and the rodent
    reset): each env's reset noise from its split of the eval key, and per
    step the latent noise of the mode policy's net key."""
    _, eval_key = jax.random.split(jax.random.PRNGKey(7))
    resets = [1e-3 * jax.random.normal(jax.random.split(k, 4)[1], (nq,))
              for k in jax.random.split(eval_key, n)]
    out = {"start_frame": torch.zeros(n, dtype=torch.long),
           "reset": torch.tensor(np.stack([np.asarray(r) for r in resets])),
           "latent": []}
    k = eval_key
    for _ in range(steps):
        step_key, k = jax.random.split(k)
        _, net_rng = jax.random.split(step_key)
        out["latent"].append(torch.tensor(np.asarray(
            jax.random.normal(net_rng, (n, latent)))))
    return out


def test_evaluate_matches_the_jax_tool(clip_pickle):
    cfg = _cfg("rodent", clip_pickle)
    jenv = jtrain.build_env(cfg, for_eval=True)
    net, params = keeper_jax()
    make_policy = jmodels.make_inference_fn(net)
    evaluator = jacting.Evaluator(
        jenvs.wrap_for_training(jenv, episode_length=STEPS),
        lambda p: make_policy(p, deterministic=True), num_eval_envs=B,
        episode_length=STEPS, action_repeat=1, key=jax.random.PRNGKey(7))
    want = evaluator.run_evaluation(params, training_metrics={},
                                    aggregate_episodes=False)
    # the per-episode lengths of that evaluation (the tool prints their
    # mean): the jitted episodes again, on the same eval key
    _, eval_key = jax.random.split(jax.random.PRNGKey(7))
    tallies = evaluator._run_episodes(params, eval_key).info["eval_metrics"]
    want_lengths = np.asarray(tallies.episode_steps)
    assert float(want_lengths.mean()) == want["eval/avg_episode_length"]

    cfg["env"]["env_args"]["fused_position"] = False     # like with like
    keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    got = eval_checkpoint.evaluate(keeper, B, cfg, device="cpu",
                                   episode_length=STEPS,
                                   noise=jax_evaluator_draws())
    np.testing.assert_allclose(got["rewards"],
                               np.asarray(want["eval/episode_reward"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["lengths"], want_lengths, rtol=1e-3,
                               atol=1e-3)
    assert (got["horizon"], got["n_envs"]) == (STEPS, B)
    # the keeper leaves the twin's clip early: an episode cut short by done
    assert 0 < want_lengths.min() < STEPS


def _keeper_state():
    """The keeper's policy as a TrainingState (value net, Adam's moments
    and the normaliser's count and variance made up)."""
    keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    state = {k: v for k, v in keeper.state_dict().items()
             if not k.startswith("obs_")}
    value = compat.value_from_numpy({"hidden_0.kernel": np.ones(
        (232, 4), np.float32), "hidden_0.bias": np.zeros(4, np.float32)},
        device="cpu").state_dict()
    moments = {f"{net}.{k}": torch.zeros_like(v) for net, sd in
               (("policy", state), ("value", value)) for k, v in sd.items()}
    norm = RunningStatisticsState(
        count=torch.tensor(5.0), mean=keeper.obs_mean.clone(),
        summed_variance=torch.ones(232), std=keeper.obs_std.clone())
    return keeper, TrainingState(
        optimizer_state={"step": 3, "exp_avg": moments,
                         "exp_avg_sq": dict(moments)},
        params={"policy": state, "value": value}, normalizer_params=norm,
        env_steps=40960)


def test_params_state_finished_and_jax_keeper_agree(tmp_path):
    keeper, ts = _keeper_state()
    params = checkpoint.save_params(str(tmp_path / "40960"),
                                    (None, keeper.state_dict()))
    finished = checkpoint.save_params(str(tmp_path / "finished"),
                                      (None, keeper.state_dict()))
    state = checkpoint.save(str(tmp_path / "state"), 40960, ts)
    jax_keeper = str(tmp_path / "keeper_state.npz")
    exporter.export_checkpoint(KEEPER_STATE, jax_keeper)

    results = {}
    for tag, path in (("params", params), ("finished", finished),
                      ("state", state), ("jax_keeper", jax_keeper)):
        policy, env_steps = checkpoint.load_policy(path, device="cpu")
        for k, v in keeper.state_dict().items():
            assert torch.equal(policy.state_dict()[k], v), (tag, k)
        assert env_steps == {"state": 40960, "jax_keeper": 230809600}.get(
            tag), tag
        results[tag] = eval_checkpoint.evaluate(
            path, 2, short_cfg(), device="cpu", episode_length=3)
        assert results[tag]["env_steps"] == env_steps
    for tag, res in results.items():
        for key in ("rewards", "lengths"):
            assert np.array_equal(res[key], results["params"][key]), (tag,
                                                                      key)
    assert np.isfinite(results["params"]["rewards"]).all()


def short_cfg():
    """The twin config with absolute paths, a 20-frame clip (horizon 15)
    and 2 physics steps a control step, so that an evaluation runs in
    seconds."""
    with open(eval_checkpoint.TWIN_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["clip_path"] = compat.TWIN_CLIP
    cfg["env"]["env_args"].update(mjcf_path=tp.TWIN_XML, clip_length=20,
                                  physics_steps_per_control_step=2)
    return cfg


def test_command_line_prints_its_json(tmp_path, capsys):
    path = tmp_path / "short.yaml"
    path.write_text(yaml.safe_dump(short_cfg()))
    rec = eval_checkpoint.main([compat.KEEPER_POLICY, "2", "--device", "cpu",
                                "--config", str(path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("deterministic eval over 2 full-clip episodes "
                      "(horizon 15):")
    assert out[1].startswith("  reward  mean=")
    assert out[2].startswith("  length  mean=") and out[2].endswith("of 15")
    line = json.loads(out[-1])["eval_checkpoint"]
    assert line == json.loads(json.dumps(rec))
    assert (line["n_envs"], line["horizon"], line["device"]) == (2, 15,
                                                                 "cpu")
    assert len(line["rewards"]) == 2 and line["env_steps"] is None
    assert 1 <= min(line["lengths"]) <= max(line["lengths"]) <= 15
    assert np.isfinite(line["reward_mean"]) and line["seconds"] > 0
