from repro_torch.nn.spec import (TensorSpec, init_params,  # noqa: F401
                                 tree_map_specs)
