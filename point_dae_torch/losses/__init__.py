"""Losses of the port."""
from .chamfer import (build_loss_func, chamfer_l1, chamfer_l2,  # noqa: F401
                      masked_chamfer_l1, masked_chamfer_l2,
                      masked_chamfer_l2_withnormal, nn_distance)
from .emd import emd_approx, emd_cost, emd_loss  # noqa: F401
