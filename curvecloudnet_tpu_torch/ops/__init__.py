"""Tensor ops of the port; ``conv1d_chain``, ``conv1d_train``,
``group_reduce``, ``group_train``, ``knn``, ``fps``, ``gather``,
``edge_mlp`` and ``grid_topk`` wrap the CUDA kernels K1, K8, K2, K7, K3,
K6, K4/K4b, K9 and K5/K10 of ``csrc/``."""
