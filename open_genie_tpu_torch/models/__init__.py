"""Models of the port: tokenizer, latent action, dynamics, Genie, and their configs."""
