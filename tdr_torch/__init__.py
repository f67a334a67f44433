"""tdr_torch — the PyTorch/CUDA port of ``tdr`` for NVIDIA Hopper (H100).

A package of its own beside ``tdr``: it imports ``torch`` and never ``jax``,
and nothing of ``tdr``.  The host text layer is a copy (``tdr_torch.text``,
``tdr_torch.native``, ``tdr_torch.data``, ``tdr_torch.eval``,
``tdr_torch.utils``); the index build, scoring, models, the dense encoder,
its trainer (``tdr_torch.train``) and router are torch code, and the four
TPU kernels of ``tdr`` are hand-written CUDA (``tdr_torch/csrc``):
``tail_compact`` and ``fused_head`` on the BM25 path, ``fused_flat`` on the
dense path, and ``head_scores`` behind its own entry point.

Every entry point takes ``device=`` (the command line, ``python -m
tdr_torch.cli``, takes ``--device``); with none given it uses ``cuda`` and
raises when CUDA is missing (it never falls back to the CPU quietly).
"""

from tdr_torch.utils.config import LANGS

__version__ = "0.1.0"
