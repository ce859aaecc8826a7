"""KVStore server-role entry — the PyTorch twin of
``mxnet_tpu/kvstore_server.py`` (reference: python/mxnet/kvstore_server.py,
where importing the framework with DMLC_ROLE=server enters the server
loop).

``tools/launch.py --num-servers`` starts the job's command with
DMLC_ROLE=server; the package import calls
``_init_kvstore_server_module`` and the process takes its role:

- a ``server`` of a ``dist_async`` job (MXNET_KVSTORE_TYPE=dist_async)
  is a real parameter server: it re-execs a fresh interpreter that
  imports the package and then serves (``parallel/ps_async.py``
  ``serve_forever``), which applies each push on arrival on the host;
- any other ``server`` and the ``scheduler`` park until SIGTERM/SIGINT
  (``dist_sync`` reduces over ``torch.distributed`` among the workers,
  so they have nothing to serve);
- a ``worker`` returns at once and the training code runs.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]

# the re-exec'd interpreter's program: the package import completes
# first (this module sees MXNET_PS_SERVING=1 and returns), then it serves
_SERVE_SRC = ("import mxnet_tpu_torch\n"
              "from mxnet_tpu_torch.parallel import ps_async\n"
              "ps_async.serve_forever()\n")


class KVStoreServer:
    """Role shim (reference kvstore_server.py:KVStoreServer) for the
    roles that have nothing to serve: ``run`` parks the process until
    the launcher's termination signal."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        """Park until SIGTERM/SIGINT (the reference's server blocked in
        its request loop until the scheduler signalled completion); the
        handlers return cleanly, so launchers that signal their children
        get an orderly exit."""
        import signal
        import threading
        done = threading.Event()

        def _stop(_sig, _frm):
            done.set()
        try:
            signal.signal(signal.SIGTERM, _stop)
            signal.signal(signal.SIGINT, _stop)
        except ValueError:                     # non-main thread
            pass
        logging.info(
            "kvstore %s role: parking (dist_sync reduces among the "
            "workers; waiting for the launcher's termination signal)",
            os.environ.get("DMLC_ROLE", "server"))
        done.wait()


def _init_kvstore_server_module():
    """Take the server or scheduler role when DMLC_ROLE names one
    (reference kvstore_server.py:_init_kvstore_server_module); returns
    False in a worker."""
    if os.environ.get("MXNET_PS_SERVING") == "1":
        # the re-exec'd server's own package import: let it finish so
        # the program can serve afterwards
        return False
    role = os.environ.get("DMLC_ROLE", "worker")
    if role not in ("server", "scheduler"):
        return False
    if role == "server" and os.environ.get(
            "MXNET_KVSTORE_TYPE", "") == "dist_async":
        # Serving cannot start here: this function runs inside the
        # package import, whose import lock would then be held for the
        # server's lifetime, and a handler thread's lazy import would
        # deadlock on it. A fresh interpreter finishes the import first,
        # then serves.
        env = dict(os.environ, MXNET_PS_SERVING="1")
        # the package's parent first on the path, whatever the cwd
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        sys.stdout.flush()
        sys.stderr.flush()
        os.execve(sys.executable, [sys.executable, "-c", _SERVE_SRC], env)
    from . import kvstore
    KVStoreServer(kvstore.create("dist")).run()
    # the reference exits after the server loop; returning would let the
    # importing training script run as an uncoordinated worker
    sys.exit(0)
