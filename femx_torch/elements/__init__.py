"""Element constants and the structured cell-matmul kernel wrapper."""
