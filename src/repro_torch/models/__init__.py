from repro_torch.models.cnn import MLPClassifier, PaperCNN, param_count

__all__ = ["MLPClassifier", "PaperCNN", "param_count"]
