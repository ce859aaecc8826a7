"""NDArray namespace (``mx.nd``): the array type, creation (``array``,
``zeros``) and save/load.
The generated operator namespace comes with the eager path (ROADMAP
Queue A item 1)."""
from .ndarray import NDArray, array, zeros, load, save, _wrap  # noqa: F401
