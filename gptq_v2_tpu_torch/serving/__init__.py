from gptq_v2_tpu_torch.serving.engine import Engine, Request, restore_requests
from gptq_v2_tpu_torch.serving.model import PackedLlama, quantize_params_to_packed
from gptq_v2_tpu_torch.serving.speculative import speculative_generate

__all__ = ["Engine", "Request", "PackedLlama", "quantize_params_to_packed",
           "restore_requests", "speculative_generate"]
