#!/usr/bin/env python
"""Entry point of the PyTorch/CUDA port (``main.py``'s counterpart); runs on
the CUDA card. Example:

    python main_torch.py --config cfgs/pretrain_synthetic_dgcnn.yaml --exp_name demo

On a host with N cards, data-parallel over all of them (one process a card):

    torchrun --nproc_per_node=N main_torch.py --config cfgs/pretrain_synthetic_dgcnn.yaml
"""
from point_dae_torch.cli import main

if __name__ == "__main__":
    main()
