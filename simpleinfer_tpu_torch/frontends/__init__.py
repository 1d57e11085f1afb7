"""Model frontends beyond the on-disk pnnx format: torch.fx export of
an eager nn.Module (torch_export) and the Hugging Face converters."""
from .torch_export import TorchExportError, export_torch

__all__ = ["TorchExportError", "export_torch"]
# hf_llama.llama_graph_from_hf (and neox / bloom / falcon / mpt / opt)
# and hf_gpt2.gpt2_graph_from_hf are imported from their own modules, as
# in the JAX package
