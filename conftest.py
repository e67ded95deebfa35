"""Session set-up for every test under the repository root.

Both packages' native I/O libraries (``native/loamio.cc``, built by each
package's ``io/native.py``) are built once here, before any test worker
loads one, each under the ``fcntl`` lock of the port's loader
(``loam_velodyne_torch/io/native.py::build_lock``): the JAX package's
loader writes its library in place, so two workers that built it at once
could load it half written. The loaders are run from their files, with
the standard library alone, so nothing of either package is imported
here.
"""

import importlib.util
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def _loader(package: str):
    spec = importlib.util.spec_from_file_location(
        f"_{package}_native_build", os.path.join(ROOT, package, "io",
                                                 "native.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build_native_libraries() -> None:
    port = _loader("loam_velodyne_torch")
    port.load()                           # locks its own build
    reference = _loader("loam_velodyne_tpu")
    with port.build_lock(reference._LIB):
        reference.load()


def pytest_configure(config):
    # Once, in the process that starts the workers (or the only one).
    if not hasattr(config, "workerinput"):
        _build_native_libraries()
