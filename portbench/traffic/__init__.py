"""General generators that turn a cell's traffic parameters and a seed
into requests or training batches."""
