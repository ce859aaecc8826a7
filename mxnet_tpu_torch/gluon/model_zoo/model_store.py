"""Local pretrained-weights store (reference:
python/mxnet/gluon/model_zoo/model_store.py).

The reference's store downloads checked-hash .params files from a
weights host. This build is zero-egress, so the store is LOCAL-ONLY:
``get_model_file(name)`` resolves ``<root>/<name>.params`` and raises a
clear error telling the user where to put the file when it is absent.
Weights trained with the reference load directly — the zoo topologies
and parameter names match (see vision.py docstring).

Root resolution order: explicit ``root`` arg, ``$MXNET_HOME/models``,
``~/.mxnet/models`` (the reference's default location, so a directory
populated by the reference framework is picked up as-is).
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "model_store_root"]


def model_store_root(root=None):
    if root:
        return os.path.expanduser(root)
    home = os.environ.get("MXNET_HOME")
    if home:
        return os.path.join(os.path.expanduser(home), "models")
    return os.path.expanduser(os.path.join("~", ".mxnet", "models"))


def get_model_file(name, root=None):
    """Path of the local ``<name>.params`` file; raises FileNotFoundError
    with provisioning instructions when absent (no network here)."""
    base = model_store_root(root)
    path = os.path.join(base, "%s.params" % name)
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(
        "pretrained weights for %r not found at %s. This build has no "
        "weights host (zero egress): place a reference-trained .params "
        "file there (gluon save_params format), or set MXNET_HOME to "
        "the directory holding models/%s.params."
        % (name, path, name))
