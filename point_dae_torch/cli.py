"""CLI argument parsing and dispatch of the port (port of
``point_dae_tpu/cli.py``; reference utils/parser.py:5-145 flags, main.py:
16-115 dispatch).

The flags, their validations, the experiment tree
``<root_folder>/<cfg_name><model_name>/<cfgs_parent>/<exp_name>`` and the
``args.`` / ``config.`` log lines are the JAX CLI's, so shell recipes and
result scrapers work unchanged. ``main(argv, device)`` runs on the CUDA card
unless ``device`` says otherwise (the tests pass ``device="cpu"``); there is
no ``--device`` flag. Every mode of the JAX CLI is dispatched, in its
order. Under ``torchrun --nproc_per_node=N main_torch.py ...`` (its
``WORLD_SIZE`` above 1) each process joins the group on ``cuda:LOCAL_RANK``
(gloo on the CPU) and trains data-parallel (``parallel/mesh.py``); rank 0
alone writes the log, ``config.yaml``, scalars and checkpoints.
"""
from __future__ import annotations

import argparse
import os
import time

from .parallel.mesh import destroy, get_mesh, initialize_distributed, prebuild
from .utils.config import cfg_from_yaml_file, propagate_corrupt_type, save_config
from .utils.device import resolve_device
from .utils.logger import get_logger, print_log


def get_args(argv=None):
    p = argparse.ArgumentParser("point_dae_torch")
    p.add_argument("--config", type=str, required=True, help="yaml config file")
    p.add_argument("--model_name", type=str, default=None,
                   help="override config.model.NAME")
    p.add_argument("--launcher", choices=["none", "spmd"], default="none",
                   help="kept for CLI parity; the process group forms from "
                        "torchrun's environment")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--sync_bn", action="store_true",
                   help="parity flag; BatchNorm statistics are always the global batch's")
    p.add_argument("--exp_name", type=str, default="default")
    p.add_argument("--loss", type=str, default="cd1",
                   help="parity flag (unconsumed in the reference too)")
    p.add_argument("--root_folder", type=str, default="experiments",
                   help="experiments root (utils/parser.py:38)")
    p.add_argument("--start_ckpts", type=str, default=None)
    p.add_argument("--ckpts", type=str, default=None)
    p.add_argument("--val_freq", type=int, default=1)
    p.add_argument("--vote", action="store_true")
    p.add_argument("--resume", action="store_true")
    # resume when ckpt-last exists (preemption-safe restarts)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_corruption", action="store_true")
    p.add_argument("--modelnet_c_root", type=str, default=None)
    p.add_argument("--so3_rotation", action="store_true")
    p.add_argument("--finetune_model", action="store_true")
    p.add_argument("--svm_classification", action="store_true")
    p.add_argument("--vis_saliency", action="store_true")
    p.add_argument("--task_affinity", action="store_true")
    p.add_argument("--scratch_model", action="store_true")
    p.add_argument("--mode", choices=["easy", "median", "hard",
                                      "z2z", "z2so3", "so32so3", None],
                   default=None)
    p.add_argument("--total_bs", type=int, default=None)
    p.add_argument("--way", type=int, default=-1)
    p.add_argument("--shot", type=int, default=-1)
    p.add_argument("--fold", type=int, default=-1)
    args = p.parse_args(argv)

    # validations as in utils/parser.py:108-122
    if args.test and args.resume:
        raise ValueError("--test and --resume are exclusive")
    if args.resume and args.start_ckpts is not None:
        raise ValueError("--resume and --start_ckpts are exclusive")
    if args.test and args.ckpts is None:
        raise ValueError("ckpts shouldn't be None in test mode")
    if args.model_name == "none":        # reference no-override sentinel
        args.model_name = None
    # exp_name decorations (utils/parser.py:127-132) shape the experiment tree
    if args.test:
        args.exp_name = "test_" + args.exp_name
    if args.test_corruption:
        args.exp_name = "test_corruption_" + args.exp_name
    if args.mode is not None:
        args.exp_name = args.exp_name + "_" + args.mode
    create_experiment_dir(args)
    return args


def create_experiment_dir(args) -> None:
    """<root>/<cfg stem + model_name>/<cfg parent>/<exp_name> tree
    (utils/parser.py:139-145)."""
    stem = os.path.splitext(os.path.basename(args.config))[0]
    if args.model_name:
        stem = stem + args.model_name
    parent = os.path.basename(os.path.dirname(args.config)) or "cfgs"
    root = getattr(args, "root_folder", "experiments")
    args.experiment_path = os.path.join(root, stem, parent, args.exp_name)
    args.tfboard_path = os.path.join(root, stem, parent, "TFBoard", args.exp_name)
    args.log_name = stem
    os.makedirs(args.experiment_path, exist_ok=True)
    os.makedirs(args.tfboard_path, exist_ok=True)


def load_config(args):
    """The config with the CLI's overrides, saved as ``config.yaml`` in the
    experiment directory."""
    cfg = cfg_from_yaml_file(args.config)
    if args.model_name:
        cfg["model"]["NAME"] = args.model_name
    if args.total_bs:
        cfg["total_bs"] = args.total_bs
    # corrupt_type propagation, pretrain only (main.py:50-55)
    if not (args.finetune_model or args.scratch_model or args.test
            or args.test_corruption):
        cfg = propagate_corrupt_type(cfg)
    # few-shot overrides (keyed on --shot like main.py:87-93)
    if args.shot != -1:
        for split in cfg.get("dataset", {}).values():
            if isinstance(split, dict) and "others" in split:
                split["others"]["way"] = args.way
                split["others"]["shot"] = args.shot
                split["others"]["fold"] = args.fold
    if get_mesh().is_main:
        save_config(cfg, os.path.join(args.experiment_path, "config.yaml"))
    return cfg


def main(argv=None, device=None):
    """Parse ``argv``, set up the experiment directory and its log, and run
    the selected mode on ``device`` (default: the CUDA card; under torchrun
    ``cuda:LOCAL_RANK``)."""
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and get_mesh().group is None
    if joined:
        mesh = initialize_distributed(device=device)
        dev = mesh.device
        prebuild(mesh)
    else:
        dev = resolve_device(device)
    try:
        return _run(argv, dev)
    finally:
        if joined:
            destroy()


def _run(argv, dev):
    args = get_args(argv)
    logger = get_logger(args.log_name,
                        os.path.join(args.experiment_path,
                                     f"{time.strftime('%Y%m%d_%H%M%S')}.log"))
    config = load_config(args)
    print_log(f"config: {args.config} model: {config['model']['NAME']}",
              logger=logger)
    # 'args.<key> : <val>' / 'config.<key> = <val>' lines are a log-format
    # API (log_args_to_file/log_config_to_file, utils/config.py:7-18)
    for key, val in vars(args).items():
        print_log(f"args.{key} : {val}", logger=logger)

    def _log_cfg(cfg, pre="config"):
        for key, val in cfg.items():
            if isinstance(val, dict):
                print_log(f"{pre}.{key} = edict()", logger=logger)
                _log_cfg(val, f"{pre}.{key}")
            else:
                print_log(f"{pre}.{key} : {val}", logger=logger)

    _log_cfg(config)

    # segmentation configs are recognised by their train dataset; --test on
    # them goes to the partseg evaluator first
    train_base = config.get("dataset", {}).get("train", {}).get("_base_", {})
    ds_name = train_base.get("NAME", "") if isinstance(train_base, dict) else str(train_base)
    is_partseg = "ShapeNetPart" in str(ds_name)
    run = dict(logger_name=args.log_name, device=dev)
    if args.test_corruption:
        from .engine.robustness import test_net_corruption

        return test_net_corruption(config, args, **run)
    if args.test and is_partseg:
        from .engine.partseg import test_partseg

        return test_partseg(config, args, **run)
    if args.test:
        if args.finetune_model:
            from .engine.finetune import test_net

            return test_net(config, args, **run)
        # --test on a pretrain config: the reconstruction visualization
        from .engine.visualization import test_vis_reconstruction

        return test_vis_reconstruction(config, args, **run)
    if args.so3_rotation:
        from .engine.rotation import run_net_rotation

        return run_net_rotation(config, args, **run)
    if args.vis_saliency:
        from .engine.saliency import vis_saliency_map

        return vis_saliency_map(config, args, **run)
    if is_partseg:
        from .engine.partseg import run_partseg

        return run_partseg(config, args, **run)
    if args.svm_classification:
        from .engine.probe import svm_classification

        return svm_classification(config, args, **run)
    if args.task_affinity:
        from .engine.probe import task_affinity

        return task_affinity(config, args, **run)
    if args.finetune_model or args.scratch_model:
        from .engine.finetune import run_finetune

        return run_finetune(config, args, **run)
    from .engine.pretrain import run_pretrain

    return run_pretrain(config, args, **run)
