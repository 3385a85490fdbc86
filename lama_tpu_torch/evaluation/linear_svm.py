"""A linear SVM for analyze_errors: the port's own `LinearSVC`, with
`sklearn.svm.LinearSVC(dual=False)`'s defaults (bin/analyze_errors.py:102),
since scikit-learn is not a dependency of the port.

liblinear's primal problem with those defaults (L2 penalty, squared hinge,
C = 1, fit_intercept with intercept_scaling = 1): each sample gets a
constant feature 1, so the intercept is a weight like the others and is
regularised with them, and

    min_w  0.5 |w|^2 + C sum_i max(0, 1 - y_i w . x_i)^2,   y_i in {-1, +1}

with y = +1 for the second of the two sorted classes. The objective is
strictly convex and piecewise quadratic; it is minimised here by Newton's
method on its exact gradient and generalised Hessian I + 2C X_A^T X_A (A
the samples inside the margin), solved in the samples' space (Woodbury),
with a backtracking line search, in float64 until the gradient's norm is
below TOL times its first norm. liblinear runs a trust-region Newton on
the same function; the two agree as far as liblinear's looser stop allows
(tests/test_torch_cli_tools.py holds them within 1e-4 of the decision
values' range).
"""
import numpy as np

C = 1.0                   # sklearn's defaults (dual=False)
INTERCEPT_SCALING = 1.0
TOL = 1e-12               # the gradient's norm, relative to its first
MAX_ITER = 100


class LinearSVC:
    """fit(X, y) on two classes; decision_function(X) = X @ coef_[0] +
    intercept_[0], positive towards classes_[1]."""

    def _augment(self, X):
        X = np.asarray(X, dtype=np.float64)
        return np.hstack([X, np.full((X.shape[0], 1),
                                     INTERCEPT_SCALING)])

    def _objective(self, w, Z):
        """Value and gradient at w; Z holds the rows y_i x_i."""
        slack = 1.0 - Z @ w
        active = slack > 0
        value = 0.5 * w @ w + C * np.sum(slack[active] ** 2)
        grad = w - 2.0 * C * Z[active].T @ slack[active]
        return value, grad, active

    def fit(self, X, y):
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f'LinearSVC takes two classes, got '
                             f'{len(self.classes_)}')
        sign = np.where(y == self.classes_[1], 1.0, -1.0)
        Z = self._augment(X) * sign[:, None]
        w = np.zeros(Z.shape[1])
        value, grad, active = self._objective(w, Z)
        g0 = np.linalg.norm(grad)
        for _ in range(MAX_ITER):
            if np.linalg.norm(grad) <= TOL * g0:
                break
            # Newton direction -(I + 2C Za^T Za)^{-1} grad, by Woodbury
            Za = Z[active]
            inner = np.eye(len(Za)) / (2.0 * C) + Za @ Za.T
            step = -(grad - Za.T @ np.linalg.solve(inner, Za @ grad))
            t, slope = 1.0, grad @ step
            while True:
                cand = self._objective(w + t * step, Z)
                if cand[0] <= value + 1e-4 * t * slope or t < 1e-12:
                    break
                t *= 0.5
            w = w + t * step
            value, grad, active = cand
        self.coef_ = w[None, :-1]
        self.intercept_ = np.array([w[-1] * INTERCEPT_SCALING])
        return self

    def decision_function(self, X):
        return np.asarray(X, dtype=np.float64) @ self.coef_[0] + \
            self.intercept_[0]
