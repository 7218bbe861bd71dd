"""M2Cache core: quantization, predictor, sparse FFN, engine, caches."""
