"""Training command line of the port (PyTorch counterpart of the root
train.py): composes vnl_tpu_torch/configs/train_config.yaml with an env
config, compiles the walker from its MJCF, loads or preprocesses the clip
(or chunks it into a multi-clip library), and runs the intention-PPO
trainer with full-state checkpoints, resume, the eval callback and the
final params.  Overrides use dotted paths; the env group is swapped with
``env_config=<path>``:

  python -m vnl_tpu_torch.train \\
      env_config=vnl_tpu_torch/configs/rodent_twin_config.yaml \\
      train.num_timesteps=40960 train.restore_checkpoint=<run>/state/N.npz

On N GPUs of one host, one process each (the port's data parallelism;
``train.num_envs`` and ``train.batch_size`` are per GPU and multiplied by
the number of processes, as the JAX package multiplies them by its device
count):

  python -m torch.distributed.run --nproc_per_node=N -m vnl_tpu_torch.train \\
      env_config=vnl_tpu_torch/configs/rodent_twin_config.yaml

Each process then runs on ``cuda:LOCAL_RANK``; rank 0 alone logs,
evaluates, renders and writes checkpoints.

Paths in the configs are relative to the working directory.  A run writes
``<checkpoint_dir>/<run id>/``: ``<steps>.npz`` params per evaluation,
``state/<steps>.npz`` full-state checkpoints and ``finished.npz``; the
metrics go to ``<log_dir>/metrics_<run id>.jsonl`` (``train.log_dir``,
default ./logs; and to wandb with ``train.use_wandb=True``).  Runs on
``cuda`` unless ``main(argv, device="cpu")``; on ``cuda`` the control step
and the SGD update replay CUDA graphs (``training.train``).
"""

from __future__ import annotations

import functools
import os
import sys
import uuid

import torch

from vnl_tpu_torch import envs as envs_lib
from vnl_tpu_torch import models as models_lib
from vnl_tpu_torch import parallel, training
from vnl_tpu_torch.data import load_clip, process_clip, process_recording
from vnl_tpu_torch.parallel import mesh
from vnl_tpu_torch.training import checkpoint as ckpt_lib
from vnl_tpu_torch.training.eval_callback import EvalCallback
from vnl_tpu_torch.utils import MetricsLogger, apply_overrides, load_config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def build_env(cfg, for_eval=False, device="cuda"):
    """The training env, or with ``for_eval`` the eval env: sub_clip_length
    maxed so that every eval episode starts at frame 0 and runs the whole
    clip, and no curriculum horizons."""
    env_cfg = cfg["env"]
    name = env_cfg["name"]
    env_args = dict(env_cfg.get("env_args", {}), device=device)
    if for_eval and "sub_clip_length" in env_args:
        env_args["sub_clip_length"] = (
            env_args["clip_length"] - env_args.get("ref_traj_length", 5))
        env_args["min_sub_clip_length"] = None
    if name == "rodent_multiclip":
        # the recording chunked into clip_length-frame clips, one library
        # entry each, processed on the walker the env compiles
        clip = load_clip(env_cfg["clip_path"], device=device)
        qpos = torch.cat([clip.position, clip.quaternion, clip.joints], 1)
        model = envs_lib.compile_rodent(
            env_args["mjcf_path"], scale_factor=env_args["scale_factor"],
            device=device)
        lib = process_recording(model, qpos.cpu().numpy(),
                                clip_length=env_args["clip_length"])
        return envs_lib.get_environment(name, clip_library=lib, **env_args)
    if name == "rodent":
        if env_cfg.get("stac_path"):
            clip = process_clip(
                stac_path=env_cfg["stac_path"],
                mjcf_path=env_args["mjcf_path"],
                scale_factor=env_args["scale_factor"],
                start_step=env_cfg.get("clip_idx", 0)
                * env_args["clip_length"],
                clip_length=env_args["clip_length"], device=device)
        else:
            clip = load_clip(env_cfg["clip_path"], device=device)
        return envs_lib.get_environment(name, reference_clip=clip,
                                        **env_args)
    if name == "humanoidtracking":
        if env_cfg.get("clip_path"):
            clip = load_clip(env_cfg["clip_path"], device=device)
            return envs_lib.get_environment(name, reference_clip=clip,
                                            **env_args)
        return envs_lib.get_environment(name, **env_args)  # built-in clip
    return envs_lib.get_environment(name, **env_args)


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    if torch.device(device).type == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"   # one GPU a rank
        torch.cuda.set_device(device)
    own_group = mesh.process_group() is None
    parallel.initialize(device=device)
    world, rank = mesh.world_size(), mesh.rank()
    env_cfg = os.path.join(CONFIGS, "env_config.yaml")
    for a in argv:  # swap env-config groups, hydra-style: env_config=<path>
        if a.startswith("env_config="):
            env_cfg = a.split("=", 1)[1]
    cfg = load_config(os.path.join(CONFIGS, "train_config.yaml"), env_cfg)
    cfg = apply_overrides(cfg, [a for a in argv if "=" in a
                                and not a.startswith("env_config=")])
    tc = cfg["train"]

    env = build_env(cfg, device=device)
    eval_env = build_env(cfg, for_eval=True, device=device)
    # scale the env count and the batch by the processes (one GPU each),
    # as the JAX package scales them by its device count
    num_envs = tc["num_envs"] * world
    batch_size = tc["batch_size"] * world

    run_id = str(uuid.uuid4())[:8]
    model_path = os.path.join(tc["checkpoint_dir"], run_id)
    # the trainer calls progress and the params callback on rank 0 only
    logger = None if rank else MetricsLogger(
        project=f"vnl_tpu_torch_{tc['task_name']}", run_name=run_id,
        config=cfg, out_dir=tc.get("log_dir", "./logs"),
        use_wandb=bool(tc.get("use_wandb", False)))

    def progress(num_steps, metrics):
        logger.log(metrics, step=num_steps)
        print(f"[{num_steps:>12}] " + " ".join(
            f"{k.split('/')[-1]}={v:.4g}" for k, v in sorted(metrics.items())
            if isinstance(v, (int, float)) and
            ("episode_reward" in k or "sps" in k)), flush=True)

    eval_cb = None

    def policy_params_fn(num_steps, make_policy, params):
        nonlocal eval_cb
        if eval_cb is None:
            eval_cb = EvalCallback(eval_env, model_path, logger,
                                   episode_length=tc["episode_length"],
                                   render=bool(tc.get("render_eval", True)))
        eval_cb(num_steps, params)

    network_factory = functools.partial(
        models_lib.make_intention_ppo_networks,
        intention_latent_size=tc["intention_latent_size"],
        encoder_layer_sizes=tuple(tc["encoder_layer_sizes"]),
        decoder_layer_sizes=tuple(tc["decoder_layer_sizes"]),
        value_hidden_layer_sizes=tuple(tc["value_hidden_layer_sizes"]),
    )

    make_policy, params, metrics = training.train(
        env,
        num_timesteps=int(tc["num_timesteps"]),
        num_evals=max(2, int(tc["num_timesteps"] / tc["eval_every"])),
        episode_length=tc["episode_length"],
        num_envs=num_envs,
        num_eval_envs=tc["num_eval_envs"],
        learning_rate=tc["learning_rate"],
        entropy_cost=tc["entropy_cost"],
        discounting=tc["discounting"],
        seed=tc["seed"],
        unroll_length=tc["unroll_length"],
        batch_size=batch_size,
        num_minibatches=tc["num_minibatches"],
        num_updates_per_batch=tc["num_updates_per_batch"],
        normalize_observations=tc["normalize_observations"],
        reward_scaling=tc["reward_scaling"],
        clipping_epsilon=tc["clipping_epsilon"],
        gae_lambda=tc["gae_lambda"],
        kl_weight=tc["kl_weight"],
        network_factory=network_factory,
        eval_env=eval_env,
        progress_fn=progress,
        policy_params_fn=policy_params_fn,
        checkpoint_dir=os.path.join(model_path, "state"),
        restore_checkpoint_path=tc.get("restore_checkpoint"),
        adaptive_clip_weights=bool(tc.get("adaptive_clip_weights", False)),
        deterministic_eval=bool(tc.get("deterministic_eval", False)),
        device=device,
    )

    if rank == 0:
        ckpt_lib.save_params(os.path.join(model_path, "finished"), params)
        logger.finish()
    if own_group and mesh.process_group() is not None:
        torch.distributed.destroy_process_group()
    return make_policy, params, metrics


if __name__ == "__main__":
    main()
