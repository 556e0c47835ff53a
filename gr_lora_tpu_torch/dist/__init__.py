"""Detection-gated multi-channel collision gateway."""
