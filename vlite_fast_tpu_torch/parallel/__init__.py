from vlite_fast_tpu_torch.parallel import (halo, mesh,  # noqa: F401
                                          sharded_pipeline)
