"""Scripts of the port, run as ``python -m curvecloudnet_tpu_torch.tools.<name>``
from the repo root: measurement scripts on a GPU, the budget tools
(``calibrate``, ``budget_audit``), ``convert_checkpoint``, and
``fake_datasets``, the tests' writer of stand-in dataset files."""
