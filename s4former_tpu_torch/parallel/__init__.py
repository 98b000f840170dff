"""Data, tensor and ZeRO-3 parallelism over ``torch.distributed``: one
process per card, on a (data, model) rank grid."""
