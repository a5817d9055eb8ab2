"""multivariates_over(field, nvars): multivariate polynomials, plus a
compiler lowering constraint systems onto the AIR `ops` namespace (the
port's own copy of `starks_tpu/algebra/multivariate.py`).

Sparse dict-of-exponent-tuples polynomials with ring ops, partial
evaluation and total degree, used to write AIR transition relations
`0 = t(cur_0..cur_{w-1}, nxt_0..nxt_{w-1}, k_0..)` declaratively.

`compile_transition` lowers a constraint system once to a straight-line
evaluation over an abstract ops namespace (add/sub/mul/cube/const), so
the same AIR definition runs on [n, 8] field tensors in the prover (one
kernel launch per op, `air.TorchOps`) and on Python ints in the verifier
(`air.HostOps`). Powers are realized by square-and-multiply chains.
Constants embed through `ops.const`, which on the device is one [1, 8]
element that the kernels read periodically; the constant term sorts
first, so `ops.add(const, column)` occurs.
"""

import functools


@functools.lru_cache(maxsize=None)
def multivariates_over(field, nvars: int):

    class MultivariatePolynomial:
        coefficient_field = field
        num_vars = nvars
        __slots__ = ("terms",)

        def __init__(self, terms=()):
            """terms: mapping {exponent-tuple: coefficient} or iterable of
            (exponent-tuple, coefficient) pairs. Zero coefficients are
            stripped; exponent tuples must have length nvars."""
            items = terms.items() if hasattr(terms, "items") else terms
            acc = {}
            for exps, c in items:
                exps = tuple(int(e) for e in exps)
                assert len(exps) == nvars, (exps, nvars)
                c = c if not isinstance(c, int) else field(c)
                if exps in acc:
                    c = acc[exps] + c
                if c:
                    acc[exps] = c
                elif exps in acc:
                    del acc[exps]
            self.terms = acc

        # -- constructors -------------------------------------------------
        @classmethod
        def constant(cls, c):
            return cls({(0,) * nvars: c})

        @classmethod
        def variable(cls, i: int):
            exps = [0] * nvars
            exps[i] = 1
            return cls({tuple(exps): field(1)})

        @classmethod
        def variables(cls):
            return [cls.variable(i) for i in range(nvars)]

        @classmethod
        def zero(cls):
            return cls({})

        @classmethod
        def one(cls):
            return cls.constant(field(1))

        # -- ring ops ------------------------------------------------------
        def __add__(self, other):
            other = _coerce(other)
            out = dict(self.terms)
            for exps, c in other.terms.items():
                s = out.get(exps, field(0)) + c
                if s:
                    out[exps] = s
                elif exps in out:
                    del out[exps]
            return MultivariatePolynomial(out)

        __radd__ = __add__

        def __neg__(self):
            return MultivariatePolynomial(
                {e: -c for e, c in self.terms.items()})

        def __sub__(self, other):
            return self + (-_coerce(other))

        def __rsub__(self, other):
            return _coerce(other) + (-self)

        def __mul__(self, other):
            other = _coerce(other)
            out = {}
            for e1, c1 in self.terms.items():
                for e2, c2 in other.terms.items():
                    e = tuple(a + b for a, b in zip(e1, e2))
                    s = out.get(e, field(0)) + c1 * c2
                    if s:
                        out[e] = s
                    elif e in out:
                        del out[e]
            return MultivariatePolynomial(out)

        __rmul__ = __mul__

        def __pow__(self, e: int):
            assert e >= 0
            result = MultivariatePolynomial.one()
            base = self
            while e:
                if e & 1:
                    result = result * base
                base = base * base
                e >>= 1
            return result

        # -- queries -------------------------------------------------------
        def total_degree(self) -> int:
            """Max term degree; -1 for the zero polynomial."""
            return max((sum(e) for e in self.terms), default=-1)

        def is_zero(self) -> bool:
            return not self.terms

        def __bool__(self):
            return bool(self.terms)

        def __eq__(self, other):
            try:
                other = _coerce(other)
            except TypeError:
                return NotImplemented
            return self.terms == other.terms

        def __ne__(self, other):
            eq = self.__eq__(other)
            return NotImplemented if eq is NotImplemented else not eq

        def __hash__(self):
            return hash((field, nvars, frozenset(self.terms.items())))

        # -- evaluation ------------------------------------------------------
        def __call__(self, values):
            """Full evaluation at a point (sequence of nvars field/int
            values)."""
            assert len(values) == nvars
            vals = [v if not isinstance(v, int) else field(v)
                    for v in values]
            acc = field(0)
            for exps, c in self.terms.items():
                term = c
                for v, e in zip(vals, exps):
                    if e:
                        term = term * v ** e
                acc = acc + term
            return acc

        def partial_eval(self, assignment: dict):
            """Substitute {var_index: value} for a subset of variables,
            returning a polynomial in the SAME nvars (substituted
            variables simply no longer occur)."""
            out = {}
            for exps, c in self.terms.items():
                coeff = c
                new_exps = list(exps)
                for i, v in assignment.items():
                    e = exps[i]
                    if e:
                        v = v if not isinstance(v, int) else field(v)
                        coeff = coeff * v ** e
                        new_exps[i] = 0
                key = tuple(new_exps)
                s = out.get(key, field(0)) + coeff
                if s:
                    out[key] = s
                elif key in out:
                    del out[key]
            return MultivariatePolynomial(out)

        def eval_with_ops(self, values, ops):
            """Evaluate over an abstract ops namespace (AIR protocol):
            `values[i]` is the i-th variable's runtime value (field
            tensor on device, int on host); coefficients/constants embed via
            `ops.const`. Exponentiation lowers to square-and-multiply."""
            acc = None
            for exps, c in sorted(self.terms.items()):
                term = None
                for v, e in zip(values, exps):
                    pw = _pow_ops(v, e, ops)
                    if pw is not None:
                        term = pw if term is None else ops.mul(term, pw)
                cval = ops.const(int(c))
                term = cval if term is None else (
                    term if c == field(1) else ops.mul(term, cval))
                acc = term if acc is None else ops.add(acc, term)
            return acc if acc is not None else ops.const(0)

        def __repr__(self):
            if not self.terms:
                return "0"
            parts = []
            for exps, c in sorted(self.terms.items()):
                mono = "*".join(f"x{i}^{e}" if e > 1 else f"x{i}"
                                for i, e in enumerate(exps) if e)
                parts.append(f"({c})" + (f"*{mono}" if mono else ""))
            return " + ".join(parts)

    def _pow_ops(v, e: int, ops):
        if e == 0:
            return None
        if e == 3 and hasattr(ops, "cube"):
            return ops.cube(v)
        result, base = None, v
        while e:
            if e & 1:
                result = base if result is None else ops.mul(result, base)
            e >>= 1
            if e:
                base = ops.mul(base, base)
        return result

    def _coerce(x):
        if isinstance(x, MultivariatePolynomial):
            return x
        if isinstance(x, (int, field)):
            return MultivariatePolynomial.constant(x)
        raise TypeError(f"cannot coerce {type(x).__name__}")

    MultivariatePolynomial.__name__ = (
        f"MultivariatePolynomial({field.__name__}, {nvars})")
    return MultivariatePolynomial


def compile_transition(constraint_polys, width: int, num_constants: int):
    """Lower multivariate constraint polynomials to an AIR transition fn.

    Variable convention (nvars = 2*width + num_constants):
      vars[0 .. width-1]              = cur registers
      vars[width .. 2*width-1]        = nxt registers
      vars[2*width .. ]               = periodic constant columns

    Returns `transition(cur, nxt, consts, ops) -> [values]` compatible
    with `starks_tpu_torch.air.AIR`: evaluated on field tensors in the
    prover and Python ints in the verifier.
    """
    nvars = 2 * width + num_constants
    for poly in constraint_polys:
        assert poly.num_vars == nvars, (poly.num_vars, nvars)

    def transition(cur, nxt, consts, ops):
        values = list(cur) + list(nxt) + list(consts)
        assert len(values) == nvars
        return [poly.eval_with_ops(values, ops)
                for poly in constraint_polys]

    return transition
