"""L2 function-evaluation runtime: the batch-evaluation protocol and its
adapters, including the device evaluator TorchBatchEvaluator."""
