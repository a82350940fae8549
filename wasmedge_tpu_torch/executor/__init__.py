from wasmedge_tpu_torch.executor.executor import Executor

__all__ = ["Executor"]
