"""Server process entry point: ``python -m
incubator_mxnet_torch.kvstore.server`` (counterpart of
`incubator_mxnet_tpu/kvstore/server.py`).

Reads the DMLC_* contract (DMLC_PS_ROOT_PORT + DMLC_SERVER_ID is the
port, DMLC_NUM_WORKER the fleet) and serves until stopped.  The server
computes on the host: it merges and updates torch CPU tensors and never
opens a CUDA context.  ``MXNET_KVSTORE_MODE=dist_async`` applies each
push as it comes instead of in sync rounds.  SIGTERM exits cleanly.
"""
import os
import signal


def main():
    signal.signal(signal.SIGTERM, lambda signum, frame: exit(0))
    from .dist import run_server
    sync = os.environ.get("MXNET_KVSTORE_MODE", "dist_sync") != "dist_async"
    run_server(sync=sync)


if __name__ == "__main__":
    main()
