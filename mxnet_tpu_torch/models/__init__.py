"""Model zoo of the port (the transformer LM so far)."""
from . import transformer  # noqa: F401
