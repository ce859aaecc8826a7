"""Parallel/distributed execution — the PyTorch twin of
``mxnet_tpu/parallel/``: the training step and its fit loop
(``TrainStep``, ``make_train_step``) over an optional mesh, the fit
loop's fault injection (``resilience``), and the mesh axes on which the
JAX package writes its collectives by hand (``_comm``): ``data`` with
ZeRO-1, ``sp`` (``ring_attention``), ``expert`` (``moe_ffn``) and
``pipe`` (``pipeline_apply``, ``pipeline_from_symbol``), over
``torch.distributed`` ranks joined by ``dist.init``.

The GSPMD part (``SpecLayout`` and the ``model``/``tp``/``fsdp`` axes)
and ``ps_async``'s asynchronous parameter server are ROADMAP Queue A
item 9b; their names raise ``NotImplementedError`` on use.
"""
from .resilience import DeadWorkerError, FaultInjector, RetryPolicy  # noqa: F401
from .trainer import make_train_step, TrainStep  # noqa: F401
from .sharding import (data_parallel_mesh, make_mesh,  # noqa: F401
                       param_sharding, batch_sharding, SpecLayout)
from .ring import ring_attention  # noqa: F401
from .pipeline import pipeline_apply, pipeline_from_symbol  # noqa: F401
from .moe import moe_ffn  # noqa: F401
from . import dist  # noqa: F401


def _ps_async_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "parallel.ps_async (AsyncPSServer, ShardedPSClient: the dist_async "
        "parameter server) is not ported to the PyTorch package yet "
        "(ROADMAP Queue A item 9b)")


AsyncPSServer = ShardedPSClient = _ps_async_not_ported
