"""One JAX reference run per test session, shared by the pytest-xdist
workers.

Under ``--dist load`` the tests of one module spread over the workers, so a
module fixture that compiles a JAX program (20–100 s on the CPU) would
compile it once on every worker that draws one of the module's tests. With
`shared`, the first worker to ask computes the value and pickles it into the
session's shared temporary directory; the others wait on a file lock and
load it. Without xdist the value is computed in place.
"""

import pickle

from filelock import FileLock


def shared(request, name: str, compute):
    """compute() once per session across workers, keyed by `name`."""
    if not hasattr(request.config, "workerinput"):
        return compute()
    root = request.getfixturevalue("tmp_path_factory").getbasetemp().parent
    path = root / f"jax_reference_{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        with open(path, "wb") as f:
            pickle.dump(value, f)
        return value
