from repro_torch.models.cnn import MLPClassifier, PaperCNN, param_count
from repro_torch.models.lm import LMClassifier
from repro_torch.models.lora import DEFAULT_TARGETS, LoRAClassifier
from repro_torch.models.transformer import TransformerLM

__all__ = ["MLPClassifier", "PaperCNN", "TransformerLM", "LMClassifier", "LoRAClassifier",
           "DEFAULT_TARGETS", "param_count"]
