"""Run a script written for `import mxnet` on the port:

    python -m incubator_mxnet_torch.run [--ctx cpu|gpu] [--seed N] \
        SCRIPT [ARGS...]

puts the package under the name `mxnet` (`mxnet_alias.install`), then
runs SCRIPT as `__main__` with ARGS as its `sys.argv[1:]` and its
directory first on `sys.path`, as `python SCRIPT ARGS` would.  The
default context is gpu(0), the card; `--ctx cpu` runs the script inside
`with mx.cpu():`, so its arrays and modules are made on the CPU.
`--seed N` calls `mx.random.seed(N)` first: the JAX package starts from
a fixed key, the port's generators from fresh entropy unless seeded.
"""
from __future__ import annotations

import contextlib
import os
import runpy
import sys

from .mxnet_alias import install

USAGE = "usage: python -m incubator_mxnet_torch.run [--ctx cpu|gpu] " \
        "[--seed N] SCRIPT [ARGS...]"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--ctx": "gpu", "--seed": None}
    while argv[:1] and argv[0] in opts and len(argv) >= 2:
        opts[argv[0]], argv = argv[1], argv[2:]
    ctx, seed = opts["--ctx"], opts["--seed"]
    if not argv or ctx not in ("cpu", "gpu") or argv[0].startswith("-"):
        raise SystemExit(USAGE)
    script = argv[0]
    mx = install()
    if seed is not None:
        mx.random.seed(int(seed))
    sys.argv = list(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    scope = mx.cpu() if ctx == "cpu" else contextlib.nullcontext()
    with scope:
        runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
