"""Benchmark workloads from the paper (§III-A, Table I + modern + spatial).

Spatial input resolutions are not given in the paper; we use the standard
resolutions of the source networks (AlexNet 227, TinyYOLO 416 with 2x pooling
between convs, Inception-v4 17x17 grid, SRCNN 33x33 patches, DeepLab output
stride 16 on 513, ESPCN on 1080p/3, MobileNet 224) and record them here so the
benchmark is reproducible.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.ndrange import (
    TensorOp, conv2d_op, correlation_op, depthwise_conv2d_op, matmul_op)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    op: TensorOp
    family: str  # classic | modern | spatial | gemm


def _conv(name, Ci, Co, k_h, k_w, oh, ow, stride=1, dilation=1) -> Workload:
    return Workload(
        name,
        conv2d_op(Co, Ci, oh, ow, k_h, k_w, stride=stride, dilation=dilation,
                  name=name),
        "classic",
    )


# --- Table I: classic CNN workloads -------------------------------------
CLASSIC: tuple[Workload, ...] = (
    _conv("AL_CONV1", 3, 48, 11, 11, 55, 55, stride=4),
    _conv("AL_CONV2", 48, 128, 5, 5, 27, 27),
    _conv("AL_CONV3", 128, 192, 3, 3, 13, 13),
    _conv("AL_CONV4", 192, 192, 3, 3, 13, 13),
    _conv("AL_CONV5", 192, 128, 3, 3, 13, 13),
    _conv("TY_CONV1", 3, 16, 3, 3, 416, 416),
    _conv("TY_CONV2", 16, 32, 3, 3, 208, 208),
    _conv("TY_CONV3", 32, 64, 3, 3, 104, 104),
    _conv("TY_CONV4", 64, 128, 3, 3, 52, 52),
    _conv("TY_CONV5", 128, 256, 3, 3, 26, 26),
    _conv("TY_CONV6", 256, 512, 3, 3, 13, 13),
    _conv("TY_CONV8", 1024, 125, 1, 1, 13, 13),
    _conv("IN_1x7", 64, 64, 1, 7, 17, 17),
    _conv("IN_7x1", 64, 64, 7, 1, 17, 17),
    _conv("SR_CONV1", 3, 64, 9, 9, 33, 33),
)

# --- Modern CNN workloads (§III-A: DeepLab, ESPCN, MobileNet) ------------
MODERN: tuple[Workload, ...] = (
    Workload("DL_ATROUS2",
             conv2d_op(256, 256, 65, 65, 3, 3, dilation=2, name="DL_ATROUS2"),
             "modern"),
    Workload("DL_ATROUS4",
             conv2d_op(256, 256, 65, 65, 3, 3, dilation=4, name="DL_ATROUS4"),
             "modern"),
    Workload("ESPCN_CONV2",
             conv2d_op(32, 64, 360, 640, 3, 3, name="ESPCN_CONV2"), "modern"),
    Workload("ESPCN_SUBPIX",
             conv2d_op(27, 32, 360, 640, 3, 3, name="ESPCN_SUBPIX"), "modern"),
    Workload("MBN_DW_S1",
             depthwise_conv2d_op(128, 56, 56, 3, 3, name="MBN_DW_S1"), "modern"),
    Workload("MBN_PW",
             conv2d_op(128, 128, 56, 56, 1, 1, name="MBN_PW"), "modern"),
)

# --- Spatial matching workloads (FlowNet correlation, EVA2 matching) -----
SPATIAL: tuple[Workload, ...] = (
    # FlowNetC correlation: 1/8-res features 48x64, 256 ch, 21x21 search.
    Workload("FLOWNET_CORR",
             correlation_op(21, 21, 64, 48, 256, name="FLOWNET_CORR"),
             "spatial"),
    # EVA2-style block matching: 17x17 search over 26x26 blocks, 64 ch.
    Workload("EVA2_MATCH",
             correlation_op(17, 17, 26, 26, 64, name="EVA2_MATCH"), "spatial"),
)

# --- GEMM (paper Fig. 3 also includes MM/GEMM workloads) ------------------
GEMM: tuple[Workload, ...] = (
    Workload("GEMM_1K", matmul_op(1024, 1024, 1024, name="GEMM_1K"), "gemm"),
    Workload("GEMM_FC", matmul_op(1, 4096, 9216, name="GEMM_FC"), "gemm"),
)

ALL: tuple[Workload, ...] = CLASSIC + MODERN + SPATIAL + GEMM


def by_name(name: str) -> Workload:
    for w in ALL:
        if w.name == name:
            return w
    raise KeyError(name)
