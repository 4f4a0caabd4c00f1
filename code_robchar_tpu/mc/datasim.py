"""MCDataSim: the cachable Monte-Carlo characterisation data layer.

API- and cache-format-compatible rebuild of the reference's MCDataSim
(mcsim.py:200-660).  The Python triple loop becomes one call into the jitted
device sweep (mc/engine.py); everything else here is host-side cache
management in the reference's JSON schemas (SURVEY.md §2.2), so caches
produced by the reference and by this engine are interchangeable:

- controller stores:  {algo: {noise_key: {"controller": [...]}}} with lbfgs
  keyed by str(Nspin) (noise_analysis.py:354-363)
- .mc fid tensors:    {algo: [[L][C][B] floats]}  (mcsim.py:457-459)
- .mcm metric dicts:  {algo: {metric[-+" upper"/" lower"]: [L][C]}}
- .tsne embeddings:   nested-list 2-D embedding per algo slot

One deliberate divergence (SURVEY.md quirk 4): cache keys are validated —
a bootreps mismatch between constructor and cache filename cannot silently
recompute, because the filename *is* the bootreps contract here too.
"""

from __future__ import annotations

import os
import glob
from typing import Callable, Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from code_robchar_tpu.exp.namer import ExperimentNamer
from code_robchar_tpu.mc import engine
from code_robchar_tpu.metrics.stats import get_ranks
from code_robchar_tpu.ops import chain, select
from code_robchar_tpu.utils import io, native_io


class DirectoryDoesNotExistError(Exception):
    pass


def remove_redundant_ticks(ax, pltrows, pltcols, remove_titles=False,
                           remove_x_title_too=False):
    """Strip inner-axis ticks/labels of a subplot grid (mcsim.py:185-196)."""
    for i in range(pltrows):
        for j in range(pltcols):
            if i != pltrows - 1:
                ax[i][j].set_xticks([])
                if remove_x_title_too:
                    ax[i][j].set_xlabel(None)
            if j != 0:
                ax[i][j].set_yticks([])
                if remove_titles:
                    ax[i][j].set_ylabel(None)


class MCDataSim:
    """Monte-Carlo data generation for structured perturbations of
    XX-chain controllers, disk-cached by filename convention."""

    def __init__(self, experiment_name: str = "pipeline_alpha",
                 Nspin: int = 5, inspin: int = 0, outspin: int = 2,
                 noises: np.ndarray = np.linspace(0, 0.1, 11),
                 bootreps: int = 100, training_noise: Optional[str] = None,
                 numcontrollers: int = 100, dkw_conflvl: float = 0.95,
                 filemarker: Optional[str] = None, topk: int = 100,
                 global_experiments_directory: str = "experiments",
                 seed: int = 0, use_jacobi: bool = False,
                 use_pallas: Optional[bool] = None):
        self.experiment_name = experiment_name
        self.Nspin = Nspin
        self.inspin = inspin
        self.outspin = outspin
        self.noises = np.asarray(noises)
        self.bootreps = bootreps
        self.training_noise = training_noise
        self.numcontrollers = numcontrollers
        self.alpha = 1 - dkw_conflvl
        self.topk = topk
        self.filemarker = filemarker
        self.global_experiments_directory = global_experiments_directory
        self.seed = seed
        self.use_jacobi = use_jacobi
        # None: ops/select.py (the Pallas Jacobi kernel on the GPU, the
        # LAPACK eigh parity path on the CPU unless use_jacobi)
        self.use_pallas = (select.use_pallas() if use_pallas is None
                           else use_pallas)

        namer = ExperimentNamer(
            experiment_name=experiment_name, Nspin=Nspin, inspin=inspin,
            outspin=outspin, numcontrollers=numcontrollers,
            global_dir=global_experiments_directory.rstrip("/"))
        self.get_controller_name = namer.controller_store()
        if filemarker is not None:
            self.get_controller_name += filemarker

        try:
            self.controllers = self.load_controllers()
            self.algos = self.ctrlnames(self.controllers)
        except FileNotFoundError as e:
            print("flagging: ", e)
            self.controllers = None
            self.algos = None

        self._h0 = chain.xx_hamiltonian_real(Nspin)

    # ------------------------------------------------------------- loading

    def load_controllers(self, controllers=None):
        if controllers is None:
            return io.load_json(self.get_controller_name)
        if isinstance(controllers, str):
            return io.load_json(controllers)
        return controllers

    def loadsimdata(self, simname: str):
        return io.load_json(simname)

    @staticmethod
    def ctrlnames(ctrlcontainer) -> List[str]:
        if isinstance(ctrlcontainer, dict):
            for key in list(ctrlcontainer):
                if ctrlcontainer[key] == {}:
                    ctrlcontainer.pop(key)
            return list(ctrlcontainer)
        if isinstance(ctrlcontainer, (list, np.ndarray)):
            return ["unnamed"]
        raise TypeError("need controller container as list or dict")

    def _algo_noise_key(self, algoname: str, training_noise) -> str:
        """lbfgs stores are keyed by str(Nspin) — the sigma_train-independent
        baseline (noise_analysis.py:319-320, SURVEY.md quirk 8)."""
        if algoname == "lbfgs":
            return str(self.Nspin)
        return str(training_noise)

    def _controller_matrix(self, algoname: str, training_noise) -> np.ndarray:
        """(numcontrollers, n+1) matrix, NaN-padded when the store holds
        fewer controllers than requested (mcsim.py:434-443)."""
        key = self._algo_noise_key(algoname, training_noise)
        conts = np.asarray(
            self.controllers[algoname][key]["controller"], dtype=float)
        if conts.size == 0:
            # an empty store (e.g. nothing passed fid_threshold) parses as
            # a 1-D (0,) array — keep the all-NaN-pad contract instead of
            # crashing the concatenate below
            conts = conts.reshape(0, self.Nspin + 1)
        c = self.numcontrollers
        if len(conts) >= c:
            return conts[:c]
        pad = np.full((c - len(conts), self.Nspin + 1), np.nan)
        return np.concatenate([conts, pad], axis=0)

    # ------------------------------------------------------------ sweeping

    def get_mcname(self, training_noise=None, noises=None) -> str:
        if training_noise is None:
            training_noise = self.training_noise
        if noises is None:
            noises = self.noises
        return io.mc_cache_name(self.get_controller_name, training_noise,
                                self.bootreps, noises)

    def get_fid_dists(self, training_noise: Optional[str] = None,
                      noises: Optional[np.ndarray] = None,
                      algoname=None) -> Dict:
        """Fidelity-distribution tensors {algo: (L, C, B) ndarray},
        loaded from the .mc cache or computed on device.  Values stay
        ndarrays in memory (every consumer re-wraps with np/jnp.asarray);
        the nested-list JSON form exists only on disk, written by the
        native codec at the dump boundary — converting a paper-scale
        ~200 MB tensor to Python lists per call was pure churn."""
        algos = [algoname] if isinstance(algoname, str) else self.algos
        noises = self.noises if noises is None else np.asarray(noises)
        if training_noise is None:
            training_noise = self.training_noise

        cache = self.get_mcname(training_noise, noises)
        if os.path.exists(cache):
            # native codec: the .mc bodies are tens of MB of JSON floats
            simdict = dict(native_io.load_mc(cache))
        else:
            simdict = {}
        for algo in algos:
            if algo not in simdict:
                self.get_algo_fid_dist(algo, simdict, noises, training_noise)
        return simdict

    def get_algo_fid_dist(self, algoname: str, allalgoallfids: Dict,
                          noises, training_noise) -> Dict:
        """One device sweep for one algorithm's controller set; appends to
        (and re-dumps) the shared .mc cache file."""
        noises = np.asarray(noises)
        tn = None if algoname == "lbfgs" else training_noise
        xs = self._controller_matrix(algoname, tn)
        valid = ~np.isnan(xs[:, 0])
        xs_valid = np.where(valid[:, None], xs, 0.0)

        fids = engine.mc_fidelity_sweep(
            self._h0, jnp.asarray(xs_valid), jnp.asarray(noises),
            jax.random.key(self.seed), self.bootreps,
            self.inspin, self.outspin, complex_offdiag=True,
            use_jacobi=self.use_jacobi or self.use_pallas,
            use_pallas=self.use_pallas)
        fids = np.array(fids)  # writable host copy
        fids[:, ~valid, :] = np.nan  # NaN-pad missing controllers

        allalgoallfids[algoname] = fids
        native_io.dump_mc(
            {k: np.asarray(v) for k, v in allalgoallfids.items()},
            io.mc_cache_name(self.get_controller_name, training_noise,
                             self.bootreps, noises))
        return allalgoallfids

    # ------------------------------------------------------------- metrics

    def get_metrics_dict(self, training_noise: Optional[str] = None,
                         noises: Optional[np.ndarray] = None,
                         algoname=None) -> Dict:
        """{algo: {metric(+ ' upper'/' lower'): [L][C]}} with the .mcm
        filename cache (mcsim.py:463-510)."""
        if training_noise is None:
            training_noise = self.training_noise
        noises = self.noises if noises is None else np.asarray(noises)
        mcm = self.get_mcname(training_noise, noises) + "m"
        out = self.loadsimdata(mcm) if os.path.exists(mcm) else {}

        algos = [algoname] if isinstance(algoname, str) else self.algos
        missing = [a for a in algos if a not in out]
        changed = False
        for algo in missing:
            # per-algo so an lbfgs (tn=None) request never forces sweeps of
            # stores that have no such training-noise key; results
            # accumulate into the shared .mc/.mcm cache files
            fid_dists = self.get_fid_dists(training_noise, noises, algo)
            tensor = jnp.asarray(fid_dists[algo])
            metrics = engine.metric_tensors(tensor, self.alpha)
            out[algo] = {k: np.asarray(v).tolist()
                         for k, v in metrics.items()}
            changed = True
        if changed:
            io.dump_json(out, mcm)
        return out

    # ------------------------------------------------- ranking / selection

    @staticmethod
    def get_ranks(array):
        return get_ranks(array)

    def get_best_controller_perf(self, metric_data: np.ndarray,
                                 contcount: Optional[int] = None):
        """Rank-sum best/median controller curves (mcsim.py:520-545).

        Returns (diff, diff_median, best_controller_per_noise,
        median_controller_per_noise, best_per_noise)."""
        metric_data = np.asarray(metric_data)
        if contcount is None:
            contcount = self.numcontrollers
        argranks = np.argsort(metric_data, axis=1)
        ranks = np.zeros_like(argranks)
        rows = np.arange(metric_data.shape[0])[:, None]
        ranks[rows, argranks] = np.arange(metric_data.shape[1])
        assert metric_data[-1][np.argmin(ranks[-1])] == np.min(
            metric_data[-1]), "rank order must be metric-ascending"
        rank_sum = ranks.sum(axis=0)
        if rank_sum.size != contcount:
            print("summation axis is incorrect!")
        order = np.argsort(rank_sum)
        best_idx = order[0]
        median_idx = order[metric_data.shape[-1] // 2]
        best_per_noise = metric_data.min(axis=1)
        best_curve = metric_data[:, best_idx]
        median_curve = metric_data[:, median_idx]
        return (best_curve - best_per_noise, median_curve - best_per_noise,
                best_curve, median_curve, best_per_noise)

    def get_top_k_by_fid_idx(self, wd_data_c, topk, idx=0):
        filmask = self.get_ranks(np.asarray(wd_data_c)[idx]) <= topk - 1
        return np.ix_(np.ones(np.asarray(wd_data_c).shape[0], dtype=bool),
                      filmask)

    def get_top_k_by_fid(self, wd_data_c, wd_data_u, wd_data_l, topk,
                         fid_thres=0.8):
        """Top-k-by-zero-noise-RIM filter with optional RIM ceiling
        (mcsim.py:651-660)."""
        wd_data_c = np.asarray(wd_data_c)
        filmask = self.get_ranks(wd_data_c[0]) <= topk - 1
        if fid_thres:
            filmask &= wd_data_c[0] <= 1 - fid_thres
        idx = np.ix_(np.ones(wd_data_c.shape[0], dtype=bool), filmask)
        return (wd_data_c[idx], np.asarray(wd_data_u)[idx],
                np.asarray(wd_data_l)[idx])

    @staticmethod
    def sort_fids_by(fids: np.ndarray, by_metric: np.ndarray,
                     best_k: int = 100):
        return np.asarray(fids)[np.argsort(by_metric, axis=-1)[:best_k]]

    def bootstrap_resampling_std(self, summarystatistic: Callable,
                                 sample: np.ndarray,
                                 bootsamples: int) -> float:
        """Host API of mcsim.py:267-275, vectorised on device."""
        val = engine.bootstrap_statistic_std(
            jax.random.key(self.seed + 1), jnp.asarray(sample),
            summarystatistic, bootsamples)
        return float(val)

    # ------------------------------------------------- controller pooling

    def get_all_algo_controllers(self) -> np.ndarray:
        """Pool every algo/noise controller set into one matrix
        (mcsim.py:251-265), zero-padding short lbfgs stores."""
        cs = []
        for alg in self.controllers:
            if alg == "lbfgs":
                conts = np.array(
                    self.controllers[alg][str(self.Nspin)]["controller"])
                if self.numcontrollers - len(conts) > 0:
                    conts = np.pad(conts,
                                   [(self.numcontrollers - len(conts), 0),
                                    (0, 0)])
                cs.append(conts)
            else:
                for noise in self.controllers[alg]:
                    cs.append(np.array(
                        self.controllers[alg][noise]["controller"]))
        return np.array(cs).reshape(-1, self.Nspin + 1)

    def set_fig_save_directory(self, cur_save_folder: str) -> None:
        """Reference figure-save directory API (mcsim.py:246-249)."""
        self.cur_save_folder = cur_save_folder
        os.makedirs(cur_save_folder, exist_ok=True)

    def save_fig(self, fig, name="noiseless_comp", pltrows=None,
                 pltcols=None, copyto=None, keepsimple=False) -> str:
        """Reference save_fig API (mcsim.py:553-563)."""
        if keepsimple:
            fname = f"{self.cur_save_folder}/{name}.pdf"
        else:
            fname = (f"{self.cur_save_folder}/{name}_c{pltcols}_r{pltrows}"
                     f"_{self.Nspin}_-{self.outspin}.pdf")
        fig.savefig(fname, dpi=300, bbox_inches="tight")
        if copyto:
            import shutil
            shutil.copy(fname, copyto)
        return fname

    def get_wd_data_c(self, algo: str = "ppo"):
        """Top-k-filtered RIM tensors for every sigma_train of one algo
        plus the lbfgs baseline (mcsim.py:317-335)."""
        rim_key = r"$W(.,\delta(x-1))$"
        noise_keys = list(self.controllers[algo].keys())
        out = []
        for nk in noise_keys:
            wd = self.get_metrics_dict(nk, self.noises, algoname=algo)[algo]
            c = np.array(wd[rim_key])
            if self.topk:
                c = c[self.get_top_k_by_fid_idx(c, self.topk)]
            out.append(c)
        if "lbfgs" in self.controllers:
            wd = self.get_metrics_dict(None, self.noises,
                                       algoname="lbfgs")["lbfgs"]
            c = np.array(wd[rim_key])
            if self.topk:
                c = c[self.get_top_k_by_fid_idx(c, self.topk)]
            out.append(c)
        return out

    def tsneconts(self, fig_path: Optional[str] = None):
        """t-SNE scatter of the pooled controller sets coloured by
        (algo, sigma_train), top-k filtered by zero-noise RIM rank
        (mcsim.py:277-315)."""
        names2nkeys = [(alg, nk) for alg in self.controllers
                       for nk in self.controllers[alg]]
        emb = self.tsne_embedding()
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        rim_key = r"$W(.,\delta(x-1))$"
        for slot, (alg, nk) in enumerate(names2nkeys[:len(emb)]):
            tn = None if alg == "lbfgs" else nk
            wd = self.get_metrics_dict(tn, self.noises, algoname=alg)[alg]
            rim0 = np.array(wd[rim_key])[0]
            keep = self.get_ranks(rim0) <= self.topk - 1
            pts = np.asarray(emb[slot])
            # short stores are padded at the FRONT of their slot
            # (_controller_slots), so the real controllers — the ones
            # rim0/keep rank — are the trailing len(rim0) rows
            pts = pts[len(pts) - len(rim0):]
            keep = keep[:len(pts)]
            label = alg if alg == "lbfgs" else \
                rf"{alg} $\sigma_{{train}}$={nk}"
            ax.scatter(pts[keep, 0], pts[keep, 1], label=label, alpha=0.5,
                       s=60, marker=rf"${alg[0]}$")
        ax.legend(fontsize=8)
        if fig_path:
            fig.savefig(fig_path, bbox_inches="tight")
            plt.close(fig)
            return fig_path
        return fig

    def _controller_slots(self):
        """Per-(algo, sigma_train) controller matrices in tsneconts'
        names2nkeys order, each front-zero-padded to ``numcontrollers``
        (the reference's lbfgs padding convention, mcsim.py:256-259,
        extended to ANY short store so the slot grid stays rectangular
        — a 50-controller ppo store must not shift every later slot's
        grouping).  Returns [(n_real, padded (numcontrollers, d)), ...]."""
        slots = []
        for alg in self.controllers:
            keys = ([str(self.Nspin)] if alg == "lbfgs"
                    else list(self.controllers[alg]))
            for k in keys:
                conts = np.array(self.controllers[alg][k]["controller"])
                n_real = len(conts)
                if self.numcontrollers - n_real > 0:
                    conts = np.pad(conts,
                                   [(self.numcontrollers - n_real, 0),
                                    (0, 0)])
                slots.append((n_real, conts[:self.numcontrollers]))
        return slots

    def tsne_embedding(self, perplexity: float = 50,
                       n_iter: int = 500) -> np.ndarray:
        """2-D t-SNE embedding of the pooled controller sets, cached to
        .tsne (mcsim.py:277-289).  Host-side (sklearn), analysis-only.
        Every (algo, sigma_train) slot is padded to ``numcontrollers``
        rows (see _controller_slots), so the returned tensor is always
        (slots, numcontrollers, 2) regardless of short stores."""
        cache = self.get_controller_name + ".tsne"
        if os.path.exists(cache):
            return np.asarray(self.loadsimdata(cache))
        from sklearn.manifold import TSNE
        slots = self._controller_slots()
        cs = np.concatenate([c for _, c in slots], axis=0)
        emb = TSNE(n_components=2, perplexity=min(perplexity, len(cs) - 1),
                   max_iter=n_iter).fit_transform(cs)
        emb = emb.reshape(len(slots), self.numcontrollers, 2)
        io.dump_json(emb.tolist(), cache)
        return emb

    # ------------------------------------------------------- cache merging

    def get_path(self, directory_exportable: str, of: str = "controllers"):
        root = os.path.join(self.global_experiments_directory,
                            directory_exportable)
        if not os.path.exists(root):
            raise DirectoryDoesNotExistError(root)
        store = ExperimentNamer(
            experiment_name=directory_exportable, Nspin=self.Nspin,
            inspin=self.inspin, outspin=self.outspin,
            numcontrollers=self.numcontrollers,
            global_dir=self.global_experiments_directory.rstrip("/")
        ).controller_store()
        if self.filemarker is not None:
            store += self.filemarker
        if of == "controllers":
            if not os.path.exists(store):
                raise DirectoryDoesNotExistError(store)
            return store
        if of == "mcm":
            return glob.glob(store + "**.mcm")
        if of == "mc":
            return glob.glob(store + "**.mc")
        raise ValueError(f"no such object type: {of}")

    def merge_controller_files(self, directory_exportable: str) -> None:
        """Union another experiment directory's controller stores into this
        one (mcsim.py:628-649): lbfgs wholesale, others per-noise-key."""
        alt = self.load_controllers(
            self.get_path(directory_exportable, of="controllers"))
        for algo in self.ctrlnames(alt):
            if algo not in self.controllers:
                self.controllers[algo] = alt[algo]
            elif algo != "lbfgs":
                for noise in alt[algo]:
                    if noise not in self.controllers[algo]:
                        self.controllers[algo][noise] = alt[algo][noise]
        io.dump_json(self.controllers, self.get_controller_name)

    def merge_mcdata(self, directory_exportable: str) -> None:
        """Merge .mc/.mcm caches algo-wise from another experiment dir
        (mcsim.py:594-621), fixing the reference's swapped-dump bug (it
        wrote metric data into the .mc path and vice versa)."""
        currfidpaths = self.get_path(self.experiment_name, of="mc")
        currmetricpaths = self.get_path(self.experiment_name, of="mcm")
        exportable = os.path.join(self.global_experiments_directory,
                                  directory_exportable)
        for fidpath, metpath in zip(currfidpaths, currmetricpaths):
            fid = self.loadsimdata(fidpath)
            met = self.loadsimdata(metpath)
            alt_fid = self.loadsimdata(
                os.path.join(exportable, os.path.basename(fidpath)))
            alt_met = self.loadsimdata(
                os.path.join(exportable, os.path.basename(metpath)))
            for algo in alt_fid:
                fid.setdefault(algo, alt_fid[algo])
            for algo in alt_met:
                met.setdefault(algo, alt_met[algo])
            io.dump_json(fid, fidpath)
            io.dump_json(met, metpath)
