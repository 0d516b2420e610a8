from deepspeed_tpu_torch.models.gpt import (GPT, GPTChunkedLoss, GPTConfig,
                                            count_params, grads_to_numpy,
                                            init_params, params_from_numpy,
                                            params_to_numpy)

__all__ = ["GPT", "GPTChunkedLoss", "GPTConfig", "count_params",
           "grads_to_numpy", "init_params", "params_from_numpy",
           "params_to_numpy"]
