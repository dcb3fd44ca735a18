"""Interpretability analyses of the port (counterpart of
``bcosification_tpu/interpretability``): the explanation methods and the
grid pointing game."""
from bcosification_tpu_torch.interpretability import analyses, explanation_methods
