"""AR-DiT model substrate: layers, attention, paged KV cache, the model."""
