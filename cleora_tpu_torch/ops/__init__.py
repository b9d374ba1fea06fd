from .spmm import CsrMatrix, spmm, spmm_axpy, spmm_axpy_plain, spmm_plain
from .normalize import (
    l1_normalize,
    l1_normalize_plain,
    l2_normalize,
    l2_normalize_plain,
    normalize,
    normalize_plain,
    spectral_normalize,
)
from .whiten import whiten
from .loop import embed_loop, embed_loop_convergence, embed_step
from .init import device_init, device_init_plain
from .attention import (
    attention_spmm,
    attention_spmm_plain,
    attention_step,
    edge_attention_weights,
    edge_attention_weights_plain,
)
from .dense import (
    dense_markov,
    dense_markov_plain,
    log_clip,
    log_clip_plain,
    rsvd_u_sqrt,
)

__all__ = [
    "CsrMatrix", "spmm", "spmm_plain", "spmm_axpy", "spmm_axpy_plain",
    "dense_markov", "dense_markov_plain", "log_clip", "log_clip_plain",
    "rsvd_u_sqrt",
    "l2_normalize", "l1_normalize", "l2_normalize_plain",
    "l1_normalize_plain", "spectral_normalize", "normalize",
    "normalize_plain", "attention_spmm", "attention_spmm_plain",
    "whiten", "embed_loop", "embed_loop_convergence", "embed_step",
    "device_init", "device_init_plain", "attention_step",
    "edge_attention_weights", "edge_attention_weights_plain",
]
