from repro_torch.optim.adamw import (OptConfig, adamw_update, global_norm, init_opt_state,
                                     schedule)
