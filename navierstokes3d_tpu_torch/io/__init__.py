"""I/O of the port: reference-format .bin and .mat dumps and .npz
checkpoints (viz, which needs matplotlib and PIL, is imported on its own:
`from navierstokes3d_tpu_torch.io import viz`)."""

from .binio import load_array, save_array, save_fields  # noqa: F401
from .checkpoint import (latest_checkpoint, load_checkpoint,  # noqa: F401
                         save_checkpoint)
from .matio import load_step_mat, save_step_mat  # noqa: F401
