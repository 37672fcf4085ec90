"""The scaling layer (port of rechorus_tpu/parallel/): a ('data', 'model')
mesh of processes over torch.distributed, row-sharded embedding tables,
the sharded full-catalog top-k and ranks, multi-process start."""
