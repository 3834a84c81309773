"""SOM trainer, initialiser and evaluator of the port."""
