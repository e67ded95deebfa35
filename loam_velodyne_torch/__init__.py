"""LOAM (LiDAR Odometry and Mapping) in PyTorch, with CUDA kernels for
NVIDIA Hopper (sm_90a).

A port of ``loam_velodyne_tpu``, which stays the reference: the module
names mirror it (``ops/scan.py``, ``models/mapping.py``, ...), and each
Pallas kernel of the JAX package has a hand-written CUDA counterpart in
``csrc/`` next to a plain PyTorch version in the same module:

- K1 ``ops/grid_kernel.py``: ring-grid window gather (ingest);
- K2 ``ops/greedy_kernel.py``: greedy suppressed feature pick;
- K3 ``ops/corresp_kernel.py``: odometry correspondence search;
- K4 ``ops/knn_kernel.py``: windowed 5-NN for the map fits.

A kernel wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors. The package stands alone: its configuration
(``config.py``), trajectory metric (``eval/metrics.py``) and sweep
simulator (``io/synthetic.py``) are its own copies of the JAX
package's, pinned equal to them by tests/test_torch_config.py; so are
its readers (``io/rosbag.py``, ``io/pcap.py``, ``io/kitti.py``,
``io/pcd.py``, with the native library built from
``native/loamio.cc``), held to the JAX readers by
tests/test_torch_io.py, and its command, ``cli.py`` (``loam-torch``),
held to the JAX command by tests/test_torch_cli.py.
"""

__version__ = "0.1.0"
