from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, RequestHandle

__all__ = ["LLMEngine", "LLMServer", "RequestHandle"]
