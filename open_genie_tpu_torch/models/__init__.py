"""Models of the port: tokenizer, dynamics, Genie, and their configs."""
