"""The plain PyTorch reference that decides ``correct``: float32, ordinary
torch operations, nothing of the program under test."""
