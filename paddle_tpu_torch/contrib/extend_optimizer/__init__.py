from .extend_optimizer_with_weight_decay import \
    extend_with_decoupled_weight_decay  # noqa: F401

__all__ = ["extend_with_decoupled_weight_decay"]
