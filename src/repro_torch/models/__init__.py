from repro_torch.models.cnn import MLPClassifier, PaperCNN, param_count
from repro_torch.models.transformer import TransformerLM

__all__ = ["MLPClassifier", "PaperCNN", "TransformerLM", "param_count"]
