"""Target-hardware constants: NVIDIA H100 SXM 80GB HBM3 at its 700 W
power limit, in nodes of 8 cards (DGX H100).  A card set below 700 W
runs slower under load than these peaks say.

A collective is charged at NVLink's rate only when every rank of its
group sits on one node (``rank // GPUS_PER_NODE`` the same for all),
and at the inter-node rate otherwise (``link_bw``).
"""
from __future__ import annotations

import torch

__all__ = ["PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "INTER_NODE_BW",
           "GPUS_PER_NODE", "DTYPE_BYTES", "same_node", "link_bw"]

# dense bf16 tensor-core rate, no sparsity (NVIDIA H100 data sheet, SXM)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
# HBM3 bandwidth (NVIDIA H100 data sheet, SXM 80GB)
HBM_BW = 3.35e12                # bytes/s per card
# fourth-generation NVLink: 900 GB/s per card to the others of its node,
# all to all, 450 GB/s each way (NVIDIA H100 data sheet)
NVLINK_BW = 450e9               # bytes/s per card, each way
# between nodes: one 400 Gb/s NDR InfiniBand port per GPU, as DGX H100
# is published (8 ConnectX-7 ports for 8 cards)
INTER_NODE_BW = 50e9            # bytes/s per card
GPUS_PER_NODE = 8               # DGX H100 / HGX H100 8-GPU

DTYPE_BYTES = {
    torch.float64: 8, torch.int64: 8, torch.uint64: 8, torch.complex64: 8,
    torch.float32: 4, torch.int32: 4, torch.uint32: 4,
    torch.bfloat16: 2, torch.float16: 2, torch.int16: 2, torch.uint16: 2,
    torch.int8: 1, torch.uint8: 1, torch.bool: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}


def same_node(ranks) -> bool:
    """Whether every global rank of ``ranks`` sits on one node."""
    return len({int(r) // GPUS_PER_NODE for r in ranks}) <= 1


def link_bw(ranks) -> float:
    """The per-card link rate a collective over ``ranks`` is charged at:
    NVLink inside a node, the inter-node rate when the group spans
    nodes."""
    return NVLINK_BW if same_node(ranks) else INTER_NODE_BW
