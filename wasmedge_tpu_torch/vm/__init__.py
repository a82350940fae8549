from wasmedge_tpu_torch.vm.async_ import Async
from wasmedge_tpu_torch.vm.vm import VM, VMStage

__all__ = ["VM", "VMStage", "Async"]
