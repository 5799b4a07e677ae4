"""The plain reference: exact k-NN in float32, the recall rule and the
comparison that decides `correct`. Plain torch and numpy; it imports
nothing of clann_tpu_torch and takes nothing the program made."""
