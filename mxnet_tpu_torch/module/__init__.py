"""Module API — the intermediate and high-level symbolic training
interface (reference python/mxnet/module/); the PyTorch twin of
``mxnet_tpu/module/`` on one device."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
