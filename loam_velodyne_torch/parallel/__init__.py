"""Batched replay: B sequences as B lanes of one op stream."""
