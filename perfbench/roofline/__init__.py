"""The yardstick's counts: the card's published peaks and, per kernel,
the operations and bytes a call needs at its inputs' real sizes."""
