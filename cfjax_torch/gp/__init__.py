from .regression import GPPosterior, gp_condition, log_marginal_likelihood
