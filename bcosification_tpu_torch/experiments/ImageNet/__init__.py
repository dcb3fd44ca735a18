"""ImageNet experiments."""
