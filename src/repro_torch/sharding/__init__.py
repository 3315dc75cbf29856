from repro_torch.sharding.partition import (batch_axes, cache_specs,
                                            opt_specs, param_specs,
                                            shard_tree)
