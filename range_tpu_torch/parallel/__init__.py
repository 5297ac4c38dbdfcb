"""Multi-device serving: a device mesh over a `torch.distributed` process
group, and bank-row sharded dense retrieval."""
