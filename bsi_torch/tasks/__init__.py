from .task import build_algorithm, build_ema, build_model, build_optimizer, build_schedule, build_task

__all__ = ["build_algorithm", "build_ema", "build_model", "build_optimizer", "build_schedule", "build_task"]
