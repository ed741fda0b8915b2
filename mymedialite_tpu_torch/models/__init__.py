"""Rating predictors of the port."""
