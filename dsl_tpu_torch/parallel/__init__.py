"""Data parallelism across processes: process groups and collectives."""
