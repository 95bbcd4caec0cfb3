"""Multi-process training over torch.distributed: the (dp, mp) layout
(``mesh``) and the launcher of the command line (``launch``)."""

from vcr_tpu_torch.parallel.mesh import (Mesh, gather_global_rows, local_rows,  # noqa: F401
                                         make_mesh, param_specs, replicate, shard_batch,
                                         shard_params, unshard_params)
