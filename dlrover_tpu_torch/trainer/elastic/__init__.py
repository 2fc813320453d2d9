"""The elastic input pipeline: the checkpointable sampler and the device
prefetcher."""
