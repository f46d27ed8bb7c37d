"""Compute layer of the port: GF(2^8) math, the CUDA shard-matmul kernel and the RS codec."""
