"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

The JAX package stays the reference; this package keeps its module
names and user surface, built slice by slice (ROADMAP.md). It imports
``torch`` and never ``jax`` or anything of ``mxnet_tpu``. Plain tensor
code is PyTorch; each kernel the JAX package wrote in Pallas for the TPU
is a kernel written by hand for Hopper under ``csrc/``, built from the
sources at first use.

Device rule: entry points run on ``cuda:0`` (the default context,
``gpu(0)``) unless the caller asks for the CPU (``ctx=mx.cpu()`` or a
``with mx.cpu():`` scope); without CUDA a gpu context raises.

Precision: float32 means float32 math. ``MXNET_MATMUL_PRECISION``
(default ``highest``) turns TF32 off for both cuBLAS matmuls and cuDNN
(PyTorch leaves cuDNN's on); ``high`` allows TF32; ``default`` leaves
PyTorch's defaults untouched.
"""
__version__ = "0.1.0"

import torch as _torch

from . import config as _config


def _set_matmul_precision(prec):
    """Apply an MXNET_MATMUL_PRECISION value to PyTorch's global flags."""
    if prec not in ("highest", "high", "default"):
        raise ValueError("MXNET_MATMUL_PRECISION must be highest, high or "
                         "default, got %r" % (prec,))
    if prec != "default":
        _torch.set_float32_matmul_precision(prec)
        _torch.backends.cuda.matmul.allow_tf32 = prec == "high"
        _torch.backends.cudnn.allow_tf32 = prec == "high"


_set_matmul_precision(_config.get("MXNET_MATMUL_PRECISION"))

from . import telemetry  # noqa: E402
from . import trace  # noqa: E402

from . import base  # noqa: E402
from .base import MXNetError  # noqa: E402

from . import context  # noqa: E402
from .context import Context, cpu, gpu, tpu, cpu_pinned, current_context  # noqa: E402,E501

from . import ops  # noqa: E402  (populates the operator registry)

from . import autograd  # noqa: E402
from . import ndarray  # noqa: E402
from . import ndarray as nd  # noqa: E402
from .ndarray import NDArray  # noqa: E402

from . import name  # noqa: E402
from . import attribute  # noqa: E402
from .attribute import AttrScope  # noqa: E402

from . import symbol  # noqa: E402
from . import symbol as sym  # noqa: E402
from .symbol import Symbol  # noqa: E402

from . import random  # noqa: E402
from . import random as rnd  # noqa: E402
from . import registry  # noqa: E402
from . import io  # noqa: E402
from . import initializer  # noqa: E402
from . import initializer as init  # noqa: E402
from . import lr_scheduler  # noqa: E402
from . import optimizer  # noqa: E402
from . import optimizer as opt  # noqa: E402
from .optimizer import Optimizer  # noqa: E402
from . import metric  # noqa: E402
from . import kvstore  # noqa: E402
from . import kvstore as kv  # noqa: E402
from . import callback  # noqa: E402
from . import monitor  # noqa: E402
from .monitor import Monitor  # noqa: E402
from . import guardrail  # noqa: E402
from . import profiler  # noqa: E402
from . import executor  # noqa: E402
from . import predictor  # noqa: E402
from .predictor import Predictor  # noqa: E402
from . import serve  # noqa: E402
from . import models  # noqa: E402
from . import generation  # noqa: E402
from . import convert  # noqa: E402
from . import model  # noqa: E402
from .model import FeedForward  # noqa: E402
from . import module  # noqa: E402
from . import module as mod  # noqa: E402
from .module import Module  # noqa: E402
from . import kvstore_server as _kvstore_server  # noqa: E402
# server/scheduler-role processes take their role here (reference:
# importing mxnet with DMLC_ROLE=server starts the server loop)
_kvstore_server._init_kvstore_server_module()
from . import parallel  # noqa: E402
from . import recordio  # noqa: E402
from . import image  # noqa: E402
from . import image as img  # noqa: E402
from . import gluon  # noqa: E402
from . import rnn  # noqa: E402
from . import operator  # noqa: E402  (mx.operator: Custom ops)
