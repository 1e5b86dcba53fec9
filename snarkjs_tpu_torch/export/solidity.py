"""Solidity verifier-contract export (port of snarkjs_tpu/export/solidity.py;
reference src/zkey_export_solidityverifier.js + templates/verifier_*.sol.ejs).

The contracts are the JAX package's, template for template, so a render is
string-equal to its render of the same verification key: a standard
pairing-precompile Groth16 verifier parameterized by the verification key,
which accepts exactly the calldata produced by
groth16.export_solidity_calldata, and the PLONK and FFLONK verifiers.  Host
only: every constant is a verification-key integer or a curve constant."""

from __future__ import annotations

from ..curves import host_curve as hc


_GROTH16_TEMPLATE = """\
// SPDX-License-Identifier: GPL-3.0
/*
    Groth16 verifier for the {curve} curve, generated by snarkjs_tpu.
    Accepts the calldata produced by `snarkjs_tpu zkey export soliditycalldata`.
*/
pragma solidity >=0.7.0 <0.9.0;

contract Groth16Verifier {{
    // Scalar field size
    uint256 constant r = {r};
    // Base field size
    uint256 constant q = {q};

    // Verification key
    uint256 constant alphax = {alphax};
    uint256 constant alphay = {alphay};
    uint256 constant betax1 = {betax1};
    uint256 constant betax2 = {betax2};
    uint256 constant betay1 = {betay1};
    uint256 constant betay2 = {betay2};
    uint256 constant gammax1 = {gammax1};
    uint256 constant gammax2 = {gammax2};
    uint256 constant gammay1 = {gammay1};
    uint256 constant gammay2 = {gammay2};
    uint256 constant deltax1 = {deltax1};
    uint256 constant deltax2 = {deltax2};
    uint256 constant deltay1 = {deltay1};
    uint256 constant deltay2 = {deltay2};

{ic_constants}

    function verifyProof(
        uint[2] calldata _pA,
        uint[2][2] calldata _pB,
        uint[2] calldata _pC,
        uint[{n_public}] calldata _pubSignals
    ) public view returns (bool) {{
        uint256[{n_ic}] memory icx;
        uint256[{n_ic}] memory icy;
{ic_loads}

        // vk_x = IC0 + sum_i pub_i * ICi, each pub_i checked < r
        uint256[4] memory addIn;
        uint256[3] memory mulIn;
        uint256[2] memory vkx = [icx[0], icy[0]];
        bool ok;
        for (uint256 i = 0; i < {n_public}; i++) {{
            require(_pubSignals[i] < r, "public input not in field");
            mulIn[0] = icx[i + 1];
            mulIn[1] = icy[i + 1];
            mulIn[2] = _pubSignals[i];
            uint256[2] memory mulOut;
            assembly {{
                ok := staticcall(sub(gas(), 2000), 7, mulIn, 96, mulOut, 64)
            }}
            require(ok, "ec mul failed");
            addIn[0] = vkx[0];
            addIn[1] = vkx[1];
            addIn[2] = mulOut[0];
            addIn[3] = mulOut[1];
            assembly {{
                ok := staticcall(sub(gas(), 2000), 6, addIn, 128, vkx, 64)
            }}
            require(ok, "ec add failed");
        }}

        // e(-A, B) * e(vk_x, gamma) * e(C, delta) * e(alpha, beta) == 1
        uint256[24] memory pairs;
        pairs[0] = _pA[0];
        pairs[1] = _pA[1] == 0 ? 0 : q - (_pA[1] % q);
        pairs[2] = _pB[0][0];
        pairs[3] = _pB[0][1];
        pairs[4] = _pB[1][0];
        pairs[5] = _pB[1][1];
        pairs[6] = vkx[0];
        pairs[7] = vkx[1];
        pairs[8] = gammax2;
        pairs[9] = gammax1;
        pairs[10] = gammay2;
        pairs[11] = gammay1;
        pairs[12] = _pC[0];
        pairs[13] = _pC[1];
        pairs[14] = deltax2;
        pairs[15] = deltax1;
        pairs[16] = deltay2;
        pairs[17] = deltay1;
        pairs[18] = alphax;
        pairs[19] = alphay;
        pairs[20] = betax2;
        pairs[21] = betax1;
        pairs[22] = betay2;
        pairs[23] = betay1;
        uint256[1] memory pairOut;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 8, pairs, 768, pairOut, 32)
        }}
        return ok && pairOut[0] == 1;
    }}
}}
"""


def export_groth16_verifier(vk: dict) -> str:
    """Render the Groth16 Solidity verifier from a vkey JSON object."""
    cv = hc.get_curve(vk["curve"])
    n_public = int(vk["nPublic"])
    ics = vk["IC"]

    def g1(o):
        return int(o[0]), int(o[1])

    def g2(o):
        return (int(o[0][0]), int(o[0][1]), int(o[1][0]), int(o[1][1]))

    ax, ay = g1(vk["vk_alpha_1"])
    bx1, bx2, by1, by2 = g2(vk["vk_beta_2"])
    gx1, gx2, gy1, gy2 = g2(vk["vk_gamma_2"])
    dx1, dx2, dy1, dy2 = g2(vk["vk_delta_2"])

    ic_constants = "\n".join(
        f"    uint256 constant IC{i}x = {g1(ic)[0]};\n"
        f"    uint256 constant IC{i}y = {g1(ic)[1]};"
        for i, ic in enumerate(ics))
    ic_loads = "\n".join(
        f"        icx[{i}] = IC{i}x;\n        icy[{i}] = IC{i}y;"
        for i in range(len(ics)))

    return _GROTH16_TEMPLATE.format(
        curve=vk["curve"], r=cv.fr.p, q=cv.fq.p,
        alphax=ax, alphay=ay,
        betax1=bx1, betax2=bx2, betay1=by1, betay2=by2,
        gammax1=gx1, gammax2=gx2, gammay1=gy1, gammay2=gy2,
        deltax1=dx1, deltax2=dx2, deltay1=dy1, deltay2=dy2,
        n_public=n_public, n_ic=len(ics),
        ic_constants=ic_constants, ic_loads=ic_loads,
    )


_PLONK_TEMPLATE = """\
// SPDX-License-Identifier: GPL-3.0
/*
    PLONK verifier for the {curve} curve, generated by snarkjs_tpu.
    Fresh implementation of the protocol of the reference
    templates/verifier_plonk.sol.ejs (same ABI + calldata layout:
    [A B C Z T1 T2 T3 Wxi Wxiw](x,y) ++ [eval_a b c s1 s2 zw]).
*/
pragma solidity >=0.7.0 <0.9.0;

contract PlonkVerifier {{
    uint256 constant r = {r};
    uint256 constant q = {q};
    uint256 constant n = {n};
    uint256 constant nPublic = {n_public};
    uint256 constant k1 = {k1};
    uint256 constant k2 = {k2};
    uint256 constant w1 = {w1};   // n-th root of unity

    uint256 constant Qmx = {Qmx};  uint256 constant Qmy = {Qmy};
    uint256 constant Qlx = {Qlx};  uint256 constant Qly = {Qly};
    uint256 constant Qrx = {Qrx};  uint256 constant Qry = {Qry};
    uint256 constant Qox = {Qox};  uint256 constant Qoy = {Qoy};
    uint256 constant Qcx = {Qcx};  uint256 constant Qcy = {Qcy};
    uint256 constant S1x = {S1x};  uint256 constant S1y = {S1y};
    uint256 constant S2x = {S2x};  uint256 constant S2y = {S2y};
    uint256 constant S3x = {S3x};  uint256 constant S3y = {S3y};
    uint256 constant X2x1 = {X2x1}; uint256 constant X2x2 = {X2x2};
    uint256 constant X2y1 = {X2y1}; uint256 constant X2y2 = {X2y2};
    // G2 generator
    uint256 constant G2x1 = {G2x1}; uint256 constant G2x2 = {G2x2};
    uint256 constant G2y1 = {G2y1}; uint256 constant G2y2 = {G2y2};

    function ecAdd(uint256[2] memory p1, uint256[2] memory p2)
            internal view returns (uint256[2] memory out) {{
        uint256[4] memory input = [p1[0], p1[1], p2[0], p2[1]];
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 6, input, 128, out, 64)
        }}
        require(ok, "ec add failed");
    }}

    function ecMul(uint256[2] memory p, uint256 s)
            internal view returns (uint256[2] memory out) {{
        uint256[3] memory input = [p[0], p[1], s];
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 7, input, 96, out, 64)
        }}
        require(ok, "ec mul failed");
    }}

    function inverse(uint256 a) internal view returns (uint256 out) {{
        // a^(r-2) mod r via the modexp precompile
        uint256[6] memory input = [uint256(32), 32, 32, a, r - 2, r];
        uint256[1] memory result;
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 5, input, 192, result, 32)
        }}
        require(ok, "modexp failed");
        return result[0];
    }}

    function checkPoint(uint256 x, uint256 y) internal pure {{
        require(x < q && y < q, "point coordinate not in field");
        require(mulmod(y, y, q)
                == addmod(mulmod(x, mulmod(x, x, q), q), 3, q),
                "point not on curve");
    }}

    function verifyProof(uint256[24] calldata _proof,
                         uint256[{pub_dim}] calldata _pubSignals)
            public view returns (bool) {{
        // ---- validate inputs
        for (uint256 i = 0; i < 18; i += 2) {{
            checkPoint(_proof[i], _proof[i + 1]);
        }}
        for (uint256 i = 18; i < 24; i++) {{
            require(_proof[i] < r, "evaluation not in field");
        }}
        for (uint256 i = 0; i < nPublic; i++) {{
            require(_pubSignals[i] < r, "public input not in field");
        }}

        // ---- Fiat-Shamir challenges (keccak over BE words, mod r)
        uint256 beta;
        {{
            bytes memory t = abi.encodePacked(
                Qmx, Qmy, Qlx, Qly, Qrx, Qry, Qox, Qoy, Qcx, Qcy,
                S1x, S1y, S2x, S2y, S3x, S3y);
            for (uint256 i = 0; i < nPublic; i++) {{
                t = abi.encodePacked(t, _pubSignals[i]);
            }}
            t = abi.encodePacked(t, _proof[0], _proof[1], _proof[2],
                                 _proof[3], _proof[4], _proof[5]);
            beta = uint256(keccak256(t)) % r;
        }}
        uint256 gamma = uint256(keccak256(abi.encodePacked(beta))) % r;
        uint256 alpha = uint256(keccak256(abi.encodePacked(
            beta, gamma, _proof[6], _proof[7]))) % r;
        uint256 xi = uint256(keccak256(abi.encodePacked(
            alpha, _proof[8], _proof[9], _proof[10], _proof[11],
            _proof[12], _proof[13]))) % r;
        uint256[6] memory v;
        v[1] = uint256(keccak256(abi.encodePacked(
            xi, _proof[18], _proof[19], _proof[20], _proof[21],
            _proof[22], _proof[23]))) % r;
        for (uint256 i = 2; i < 6; i++) {{
            v[i] = mulmod(v[i - 1], v[1], r);
        }}
        uint256 u = uint256(keccak256(abi.encodePacked(
            _proof[14], _proof[15], _proof[16], _proof[17]))) % r;

        return _verifyEquation(_proof, _pubSignals, beta, gamma, alpha, xi,
                               v, u);
    }}

    function _verifyEquation(uint256[24] calldata _proof,
                             uint256[{pub_dim}] calldata _pubSignals,
                             uint256 beta, uint256 gamma, uint256 alpha,
                             uint256 xi, uint256[6] memory v, uint256 u)
            internal view returns (bool) {{
        // ---- Lagrange evaluations and PI
        uint256 xin = _pow(xi, n);
        uint256 zh = addmod(xin, r - 1, r);
        uint256 pi = 0;
        uint256 L1 = 0;
        {{
            uint256 wcur = 1;
            for (uint256 i = 0; i < (nPublic > 0 ? nPublic : 1); i++) {{
                uint256 li = mulmod(
                    mulmod(wcur, zh, r),
                    inverse(mulmod(n, addmod(xi, r - wcur, r), r)), r);
                if (i == 0) {{ L1 = li; }}
                if (i < nPublic) {{
                    pi = addmod(pi, r - mulmod(_pubSignals[i], li, r), r);
                }}
                wcur = mulmod(wcur, w1, r);
            }}
        }}

        // ---- r0
        uint256 r0;
        {{
            uint256 e3a = addmod(_proof[18],
                addmod(mulmod(beta, _proof[21], r), gamma, r), r);
            uint256 e3b = addmod(_proof[19],
                addmod(mulmod(beta, _proof[22], r), gamma, r), r);
            uint256 e3c = addmod(_proof[20], gamma, r);
            uint256 e3 = mulmod(mulmod(mulmod(e3a, e3b, r), e3c, r),
                                mulmod(_proof[23], alpha, r), r);
            r0 = addmod(pi, r - addmod(
                mulmod(mulmod(L1, alpha, r), alpha, r), e3, r), r);
        }}

        // ---- D, F, E, A1, B1
        uint256[2] memory D = _computeD(_proof, beta, gamma, alpha, xi,
                                        u, L1, xin, zh);
        uint256[2] memory F = ecAdd(D,
            ecAdd(ecMul([_proof[0], _proof[1]], v[1]),
            ecAdd(ecMul([_proof[2], _proof[3]], v[2]),
            ecAdd(ecMul([_proof[4], _proof[5]], v[3]),
            ecAdd(ecMul([S1x, S1y], v[4]),
                  ecMul([S2x, S2y], v[5]))))));
        uint256 e = addmod(r - r0, addmod(
            addmod(mulmod(v[1], _proof[18], r), mulmod(v[2], _proof[19], r), r),
            addmod(addmod(mulmod(v[3], _proof[20], r),
                          mulmod(v[4], _proof[21], r), r),
                   addmod(mulmod(v[5], _proof[22], r),
                          mulmod(u, _proof[23], r), r)), r), r);
        uint256[2] memory E = ecMul([uint256(1), uint256(2)], e);

        uint256[2] memory A1 = ecAdd([_proof[14], _proof[15]],
                                     ecMul([_proof[16], _proof[17]], u));
        uint256[2] memory B1;
        {{
            uint256 s = mulmod(mulmod(u, xi, r), w1, r);
            B1 = ecAdd(ecMul([_proof[14], _proof[15]], xi),
                       ecMul([_proof[16], _proof[17]], s));
            B1 = ecAdd(B1, F);
            B1 = ecAdd(B1, [E[0], E[1] == 0 ? 0 : q - E[1]]);
        }}

        // ---- e(-A1, X_2) * e(B1, G2) == 1
        uint256[12] memory pairs;
        pairs[0] = A1[0];
        pairs[1] = A1[1] == 0 ? 0 : q - A1[1];
        pairs[2] = X2x2; pairs[3] = X2x1;
        pairs[4] = X2y2; pairs[5] = X2y1;
        pairs[6] = B1[0];
        pairs[7] = B1[1];
        pairs[8] = G2x2; pairs[9] = G2x1;
        pairs[10] = G2y2; pairs[11] = G2y1;
        uint256[1] memory pairOut;
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 8, pairs, 384, pairOut, 32)
        }}
        return ok && pairOut[0] == 1;
    }}

    function _computeD(uint256[24] calldata _proof, uint256 beta,
                       uint256 gamma, uint256 alpha, uint256 xi, uint256 u,
                       uint256 L1, uint256 xin, uint256 zh)
            internal view returns (uint256[2] memory D) {{
        uint256[2] memory d1 = ecMul([Qmx, Qmy],
            mulmod(_proof[18], _proof[19], r));
        d1 = ecAdd(d1, ecMul([Qlx, Qly], _proof[18]));
        d1 = ecAdd(d1, ecMul([Qrx, Qry], _proof[19]));
        d1 = ecAdd(d1, ecMul([Qox, Qoy], _proof[20]));
        d1 = ecAdd(d1, [Qcx, Qcy]);

        uint256 betaxi = mulmod(beta, xi, r);
        uint256 d2a = mulmod(mulmod(mulmod(
            addmod(_proof[18], addmod(betaxi, gamma, r), r),
            addmod(_proof[19],
                   addmod(mulmod(betaxi, k1, r), gamma, r), r), r),
            addmod(_proof[20],
                   addmod(mulmod(betaxi, k2, r), gamma, r), r), r),
            alpha, r);
        uint256 d2b = mulmod(mulmod(L1, alpha, r), alpha, r);
        uint256[2] memory d2 = ecMul([_proof[6], _proof[7]],
            addmod(addmod(d2a, d2b, r), u, r));

        uint256 d3s = mulmod(mulmod(
            addmod(_proof[18],
                   addmod(mulmod(beta, _proof[21], r), gamma, r), r),
            addmod(_proof[19],
                   addmod(mulmod(beta, _proof[22], r), gamma, r), r), r),
            mulmod(mulmod(alpha, beta, r), _proof[23], r), r);
        uint256[2] memory d3 = ecMul([S3x, S3y], d3s);

        uint256[2] memory d4 = ecAdd([_proof[8], _proof[9]],
            ecAdd(ecMul([_proof[10], _proof[11]], xin),
                  ecMul([_proof[12], _proof[13]], mulmod(xin, xin, r))));
        d4 = ecMul(d4, zh);

        D = ecAdd(d1, d2);
        D = ecAdd(D, [d3[0], d3[1] == 0 ? 0 : q - d3[1]]);
        D = ecAdd(D, [d4[0], d4[1] == 0 ? 0 : q - d4[1]]);
    }}

    function _pow(uint256 b, uint256 e) internal pure returns (uint256) {{
        uint256 acc = 1;
        uint256 cur = b;
        while (e > 0) {{
            if (e & 1 == 1) {{ acc = mulmod(acc, cur, r); }}
            cur = mulmod(cur, cur, r);
            e >>= 1;
        }}
        return acc;
    }}
}}
"""


def export_plonk_verifier(vk: dict) -> str:
    """Render the PLONK Solidity verifier from a vkey JSON object."""
    cv = hc.get_curve(vk["curve"])
    n_public = int(vk["nPublic"])
    power = int(vk["power"])

    def g1(name):
        o = vk[name]
        return int(o[0]), int(o[1])

    x2 = vk["X_2"]
    subs = dict(curve=vk["curve"], r=cv.fr.p, q=cv.fq.p,
                n=1 << power, n_public=n_public,
                pub_dim=max(1, n_public),
                k1=int(vk["k1"]), k2=int(vk["k2"]),
                w1=cv.fr.w[power],
                X2x1=int(x2[0][0]), X2x2=int(x2[0][1]),
                X2y1=int(x2[1][0]), X2y2=int(x2[1][1]),
                G2x1=cv.g2[0][0], G2x2=cv.g2[0][1],
                G2y1=cv.g2[1][0], G2y2=cv.g2[1][1])
    for nm in ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3"):
        x, y = g1(nm)
        subs[nm + "x"] = x
        subs[nm + "y"] = y
    return _PLONK_TEMPLATE.format(**subs)


_FFLONK_TEMPLATE = """\
// SPDX-License-Identifier: GPL-3.0
/*
    FFLONK verifier for the {curve} curve, generated by snarkjs_tpu.
    Fresh implementation of the protocol of the reference
    templates/verifier_fflonk.sol.ejs (same ABI + 24-word calldata:
    [C1 C2 W1 W2](x,y) ++ [ql qr qm qo qc s1 s2 s3 a b c z zw t1w t2w inv];
    denominators are inverted with the modexp precompile, so the prover's
    batched `inv` word is not consumed).
*/
pragma solidity >=0.7.0 <0.9.0;

contract FflonkVerifier {{
    uint256 constant r = {r};
    uint256 constant q = {q};
    uint256 constant n = {n};
    uint256 constant nPublic = {n_public};
    uint256 constant k1 = {k1};
    uint256 constant k2 = {k2};
    uint256 constant w1 = {w1};
    uint256 constant w3 = {w3};
    uint256 constant w4 = {w4};
    uint256 constant w8 = {w8};
    uint256 constant wr = {wr};
    uint256 constant C0x = {C0x};
    uint256 constant C0y = {C0y};
    uint256 constant X2x1 = {X2x1}; uint256 constant X2x2 = {X2x2};
    uint256 constant X2y1 = {X2y1}; uint256 constant X2y2 = {X2y2};
    uint256 constant G2x1 = {G2x1}; uint256 constant G2x2 = {G2x2};
    uint256 constant G2y1 = {G2y1}; uint256 constant G2y2 = {G2y2};

    function ecAdd(uint256[2] memory p1, uint256[2] memory p2)
            internal view returns (uint256[2] memory out) {{
        uint256[4] memory input = [p1[0], p1[1], p2[0], p2[1]];
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 6, input, 128, out, 64)
        }}
        require(ok, "ec add failed");
    }}

    function ecMul(uint256[2] memory p, uint256 s)
            internal view returns (uint256[2] memory out) {{
        uint256[3] memory input = [p[0], p[1], s];
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 7, input, 96, out, 64)
        }}
        require(ok, "ec mul failed");
    }}

    function inverse(uint256 a) internal view returns (uint256) {{
        uint256[6] memory input = [uint256(32), 32, 32, a, r - 2, r];
        uint256[1] memory result;
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 5, input, 192, result, 32)
        }}
        require(ok, "modexp failed");
        return result[0];
    }}

    function pow3(uint256 a) internal pure returns (uint256) {{
        return mulmod(mulmod(a, a, r), a, r);
    }}

    function powN(uint256 b, uint256 e) internal pure returns (uint256) {{
        uint256 acc = 1;
        uint256 cur = b;
        while (e > 0) {{
            if (e & 1 == 1) {{ acc = mulmod(acc, cur, r); }}
            cur = mulmod(cur, cur, r);
            e >>= 1;
        }}
        return acc;
    }}

    struct Ch {{
        uint256 beta; uint256 gamma; uint256 xiSeed; uint256 alpha;
        uint256 y; uint256 xi; uint256 xin; uint256 zh; uint256 invzh;
        uint256 L1; uint256 pi;
    }}

    function verifyProof(bytes32[24] calldata proof,
                         uint256[{pub_dim}] calldata pubSignals)
            public view returns (bool) {{
        uint256[24] memory P;
        for (uint256 i = 0; i < 24; i++) {{
            P[i] = uint256(proof[i]);
        }}
        for (uint256 i = 0; i < 8; i += 2) {{
            require(P[i] < q && P[i + 1] < q, "coordinate not in field");
            require(mulmod(P[i + 1], P[i + 1], q) ==
                    addmod(mulmod(P[i], mulmod(P[i], P[i], q), q), 3, q),
                    "point not on curve");
        }}
        for (uint256 i = 8; i < 24; i++) {{
            require(P[i] < r, "evaluation not in field");
        }}
        for (uint256 i = 0; i < nPublic; i++) {{
            require(pubSignals[i] < r, "public input not in field");
        }}

        Ch memory ch;
        {{
            bytes memory t = abi.encodePacked(C0x, C0y);
            for (uint256 i = 0; i < nPublic; i++) {{
                t = abi.encodePacked(t, pubSignals[i]);
            }}
            ch.beta = uint256(keccak256(
                abi.encodePacked(t, P[0], P[1]))) % r;
        }}
        ch.gamma = uint256(keccak256(abi.encodePacked(ch.beta))) % r;
        ch.xiSeed = uint256(keccak256(
            abi.encodePacked(ch.gamma, P[2], P[3]))) % r;
        ch.alpha = uint256(keccak256(abi.encodePacked(
            ch.xiSeed, P[8], P[9], P[10], P[11], P[12], P[13], P[14],
            P[15], P[16], P[17], P[18], P[19], P[20], P[21], P[22]))) % r;
        ch.y = uint256(keccak256(
            abi.encodePacked(ch.alpha, P[4], P[5]))) % r;

        // roots ladders from xiSeed
        uint256[8] memory h0w8;
        uint256[4] memory h1w4;
        uint256[3] memory h2w3;
        uint256[3] memory h3w3;
        {{
            uint256 h0 = pow3(ch.xiSeed);
            h0w8[0] = h0;
            for (uint256 i = 1; i < 8; i++) {{
                h0w8[i] = mulmod(h0w8[i - 1], w8, r);
            }}
            uint256 h1 = mulmod(h0, h0, r);
            h1w4[0] = h1;
            for (uint256 i = 1; i < 4; i++) {{
                h1w4[i] = mulmod(h1w4[i - 1], w4, r);
            }}
            uint256 h2 = mulmod(mulmod(h1, ch.xiSeed, r), ch.xiSeed, r);
            h2w3[0] = h2;
            h2w3[1] = mulmod(h2, w3, r);
            h2w3[2] = mulmod(h2w3[1], w3, r);
            uint256 h3 = mulmod(h2, wr, r);
            h3w3[0] = h3;
            h3w3[1] = mulmod(h3, w3, r);
            h3w3[2] = mulmod(h3w3[1], w3, r);
            ch.xi = pow3(h2);
        }}
        ch.xin = powN(ch.xi, n);
        ch.zh = addmod(ch.xin, r - 1, r);
        require(ch.zh != 0, "xi in evaluation domain");
        ch.invzh = inverse(ch.zh);
        ch.L1 = mulmod(ch.zh, inverse(mulmod(n, addmod(ch.xi, r - 1, r),
                                             r)), r);
        {{
            uint256 wcur = 1;
            ch.pi = 0;
            for (uint256 i = 0; i < nPublic; i++) {{
                uint256 li = mulmod(mulmod(wcur, ch.zh, r), inverse(
                    mulmod(n, addmod(ch.xi, r - wcur, r), r)), r);
                ch.pi = addmod(ch.pi,
                               r - mulmod(pubSignals[i], li, r), r);
                wcur = mulmod(wcur, w1, r);
            }}
        }}

        return _final(P, ch, h0w8, h1w4, h2w3, h3w3);
    }}

    function _r0(uint256[24] memory P, Ch memory ch,
                 uint256[8] memory h0w8) internal view returns (uint256) {{
        uint256 num = addmod(powN(ch.y, 8), r - ch.xi, r);
        uint256 den1 = mulmod(8, powN(h0w8[0], 6), r);
        uint256 res = 0;
        for (uint256 i = 0; i < 8; i++) {{
            uint256 li = mulmod(num, inverse(mulmod(mulmod(
                den1, h0w8[(7 * i) % 8], r),
                addmod(ch.y, r - h0w8[i], r), r)), r);
            // c0(h) = ql + h*qr + h^2*qo + h^3*qm + h^4*qc
            //         + h^5*s1 + h^6*s2 + h^7*s3   (prover interleaving)
            uint256 h = h0w8[i];
            uint256 acc = P[8];
            uint256 hp = h;
            acc = addmod(acc, mulmod(P[9], hp, r), r);  hp = mulmod(hp, h, r);
            acc = addmod(acc, mulmod(P[11], hp, r), r); hp = mulmod(hp, h, r);
            acc = addmod(acc, mulmod(P[10], hp, r), r); hp = mulmod(hp, h, r);
            acc = addmod(acc, mulmod(P[12], hp, r), r); hp = mulmod(hp, h, r);
            acc = addmod(acc, mulmod(P[13], hp, r), r); hp = mulmod(hp, h, r);
            acc = addmod(acc, mulmod(P[14], hp, r), r); hp = mulmod(hp, h, r);
            acc = addmod(acc, mulmod(P[15], hp, r), r);
            res = addmod(res, mulmod(acc, li, r), r);
        }}
        return res;
    }}

    function _r1(uint256[24] memory P, Ch memory ch,
                 uint256[4] memory h1w4) internal view returns (uint256) {{
        uint256 t0 = mulmod(addmod(addmod(addmod(
            mulmod(P[8], P[16], r), mulmod(P[9], P[17], r), r),
            addmod(mulmod(P[10], mulmod(P[16], P[17], r), r),
                   mulmod(P[11], P[18], r), r), r),
            addmod(P[12], ch.pi, r), r), ch.invzh, r);
        uint256 num = addmod(powN(ch.y, 4), r - ch.xi, r);
        uint256 den1 = mulmod(4, powN(h1w4[0], 2), r);
        uint256 res = 0;
        for (uint256 i = 0; i < 4; i++) {{
            uint256 li = mulmod(num, inverse(mulmod(mulmod(
                den1, h1w4[(3 * i) % 4], r),
                addmod(ch.y, r - h1w4[i], r), r)), r);
            uint256 h = h1w4[i];
            uint256 acc = addmod(P[16], mulmod(h, P[17], r), r);
            acc = addmod(acc, mulmod(mulmod(h, h, r), P[18], r), r);
            acc = addmod(acc, mulmod(pow3(h), t0, r), r);
            res = addmod(res, mulmod(acc, li, r), r);
        }}
        return res;
    }}

    function _r2(uint256[24] memory P, Ch memory ch,
                 uint256[3] memory h2w3, uint256[3] memory h3w3)
            internal view returns (uint256) {{
        uint256 xiw = mulmod(ch.xi, w1, r);
        uint256 t1 = mulmod(mulmod(addmod(P[19], r - 1, r), ch.L1, r),
                            ch.invzh, r);
        uint256 t2;
        {{
            uint256 betaxi = mulmod(ch.beta, ch.xi, r);
            uint256 a1 = mulmod(mulmod(
                addmod(P[16], addmod(betaxi, ch.gamma, r), r),
                addmod(P[17], addmod(mulmod(betaxi, k1, r), ch.gamma, r),
                       r), r),
                mulmod(addmod(P[18],
                              addmod(mulmod(betaxi, k2, r), ch.gamma, r),
                              r), P[19], r), r);
            uint256 a2 = mulmod(mulmod(
                addmod(P[16],
                       addmod(mulmod(ch.beta, P[13], r), ch.gamma, r), r),
                addmod(P[17],
                       addmod(mulmod(ch.beta, P[14], r), ch.gamma, r), r),
                r),
                mulmod(addmod(P[18],
                       addmod(mulmod(ch.beta, P[15], r), ch.gamma, r), r),
                       P[20], r), r);
            t2 = mulmod(addmod(a1, r - a2, r), ch.invzh, r);
        }}
        uint256 num = addmod(addmod(powN(ch.y, 6), r - mulmod(
            addmod(ch.xi, xiw, r), pow3(ch.y), r), r),
            mulmod(ch.xi, xiw, r), r);
        uint256 res = 0;
        {{
            uint256 den1 = mulmod(mulmod(3, h2w3[0], r),
                                  addmod(ch.xi, r - xiw, r), r);
            for (uint256 i = 0; i < 3; i++) {{
                uint256 li = mulmod(num, inverse(mulmod(mulmod(
                    den1, h2w3[(2 * i) % 3], r),
                    addmod(ch.y, r - h2w3[i], r), r)), r);
                uint256 h = h2w3[i];
                uint256 acc = addmod(P[19], mulmod(h, t1, r), r);
                acc = addmod(acc, mulmod(mulmod(h, h, r), t2, r), r);
                res = addmod(res, mulmod(acc, li, r), r);
            }}
        }}
        {{
            uint256 den1 = mulmod(mulmod(3, h3w3[0], r),
                                  addmod(xiw, r - ch.xi, r), r);
            for (uint256 i = 0; i < 3; i++) {{
                uint256 li = mulmod(num, inverse(mulmod(mulmod(
                    den1, h3w3[(2 * i) % 3], r),
                    addmod(ch.y, r - h3w3[i], r), r)), r);
                uint256 h = h3w3[i];
                uint256 acc = addmod(P[20], mulmod(h, P[21], r), r);
                acc = addmod(acc, mulmod(mulmod(h, h, r), P[22], r), r);
                res = addmod(res, mulmod(acc, li, r), r);
            }}
        }}
        return res;
    }}

    function _final(uint256[24] memory P, Ch memory ch,
                    uint256[8] memory h0w8, uint256[4] memory h1w4,
                    uint256[3] memory h2w3, uint256[3] memory h3w3)
            internal view returns (bool) {{
        uint256 mulH0 = 1;
        for (uint256 i = 0; i < 8; i++) {{
            mulH0 = mulmod(mulH0, addmod(ch.y, r - h0w8[i], r), r);
        }}
        uint256 mulH1 = 1;
        for (uint256 i = 0; i < 4; i++) {{
            mulH1 = mulmod(mulH1, addmod(ch.y, r - h1w4[i], r), r);
        }}
        uint256 mulH2 = 1;
        for (uint256 i = 0; i < 3; i++) {{
            mulH2 = mulmod(mulH2, addmod(ch.y, r - h2w3[i], r), r);
            mulH2 = mulmod(mulH2, addmod(ch.y, r - h3w3[i], r), r);
        }}
        uint256 quo1 = mulmod(ch.alpha,
                              mulmod(mulH0, inverse(mulH1), r), r);
        uint256 quo2 = mulmod(mulmod(ch.alpha, ch.alpha, r),
                              mulmod(mulH0, inverse(mulH2), r), r);

        uint256[2] memory F = ecAdd([C0x, C0y],
            ecAdd(ecMul([P[0], P[1]], quo1), ecMul([P[2], P[3]], quo2)));
        uint256 e = addmod(_r0(P, ch, h0w8), addmod(
            mulmod(_r1(P, ch, h1w4), quo1, r),
            mulmod(_r2(P, ch, h2w3, h3w3), quo2, r), r), r);
        uint256[2] memory E = ecMul([uint256(1), uint256(2)], e);
        uint256[2] memory J = ecMul([P[4], P[5]], mulH0);

        uint256[2] memory A1 = ecMul([P[6], P[7]], ch.y);
        A1 = ecAdd(A1, F);
        A1 = ecAdd(A1, [E[0], E[1] == 0 ? 0 : q - E[1]]);
        A1 = ecAdd(A1, [J[0], J[1] == 0 ? 0 : q - J[1]]);

        uint256[12] memory pairs;
        pairs[0] = A1[0];
        pairs[1] = A1[1] == 0 ? 0 : q - A1[1];
        pairs[2] = G2x2; pairs[3] = G2x1;
        pairs[4] = G2y2; pairs[5] = G2y1;
        pairs[6] = P[6];
        pairs[7] = P[7];
        pairs[8] = X2x2; pairs[9] = X2x1;
        pairs[10] = X2y2; pairs[11] = X2y1;
        uint256[1] memory pairOut;
        bool ok;
        assembly {{
            ok := staticcall(sub(gas(), 2000), 8, pairs, 384, pairOut, 32)
        }}
        return ok && pairOut[0] == 1;
    }}
}}
"""


def export_fflonk_verifier(vk: dict) -> str:
    """Render the FFLONK Solidity verifier from a vkey JSON object."""
    cv = hc.get_curve(vk["curve"])
    n_public = int(vk["nPublic"])
    power = int(vk["power"])
    x2 = vk["X_2"]
    c0 = vk["C0"]
    return _FFLONK_TEMPLATE.format(
        curve=vk["curve"], r=cv.fr.p, q=cv.fq.p,
        n=1 << power, n_public=n_public, pub_dim=max(1, n_public),
        k1=int(vk["k1"]), k2=int(vk["k2"]),
        w1=int(vk["w"]), w3=int(vk["w3"]), w4=int(vk["w4"]),
        w8=int(vk["w8"]), wr=int(vk["wr"]),
        C0x=int(c0[0]), C0y=int(c0[1]),
        X2x1=int(x2[0][0]), X2x2=int(x2[0][1]),
        X2y1=int(x2[1][0]), X2y2=int(x2[1][1]),
        G2x1=cv.g2[0][0], G2x2=cv.g2[0][1],
        G2y1=cv.g2[1][0], G2y2=cv.g2[1][1])


def export_verifier(vk: dict) -> str:
    if vk.get("protocol") == "groth16":
        return export_groth16_verifier(vk)
    if vk.get("protocol") == "plonk":
        return export_plonk_verifier(vk)
    if vk.get("protocol") == "fflonk":
        return export_fflonk_verifier(vk)
    raise NotImplementedError(
        f"Solidity verifier export for {vk.get('protocol')} is not "
        "implemented")
