"""wasmedge_tpu_torch: the PyTorch/CUDA port of the batched Wasm runtime.

Runs thousands of WebAssembly instances as lanes of one device state on
an NVIDIA GPU, bit-exact against the JAX package `wasmedge_tpu`, which
stays in the repository as the reference.  The main path:

    vm = VM(conf); vm.load_wasm(data); vm.validate(); vm.instantiate()
    vm.execute_batch("fib", [np.full(4096, 30)])   # on the card

(`wasmedge_tpu_torch.vm.vm.VM`); entry points take `device="cpu"` to run
the plain PyTorch interpreter instead of the CUDA kernel.  `vm.execute`
and `vm.run_wasm_file` run one call on the scalar engine on the host
(`wasmedge_tpu_torch.executor`), which also runs start functions at
instantiation.
"""
