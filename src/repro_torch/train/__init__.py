from repro_torch.train.step import (TrainSpec, init_train_state, make_decode_step,
                                    make_prefill_step, make_train_step, microbatch_reshape)
