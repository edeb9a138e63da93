"""The port's model stack: attention layers with dense or MoE FFNs."""
from repro_torch.models.params import (ParamDef, init_params,
                                       init_serving_params, model_defs,
                                       params_from_jax, params_to_jax,
                                       state_from_jax, state_to_jax)
from repro_torch.models.transformer import (Block, Transformer,
                                            cast_for_compute, decode_step,
                                            init_cache, prefill, train_logits)
