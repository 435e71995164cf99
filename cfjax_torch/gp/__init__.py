from .regression import GPPosterior, gp_condition, log_marginal_likelihood
from .fit import fit_kernel
from .hmc import hmc_sample, nuts_sample
